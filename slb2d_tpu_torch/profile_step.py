"""Where a step's time goes on the card: a single-run kernel engine under
torch.profiler, per CUDA kernel, with the device's busy and idle share of
the window's wall time.

    python -m slb2d_tpu_torch.profile_step [n_steps] [f32|f64] \\
        [impl=cuda|stream] [n-harmonics=100] [g-grid=4000]

impl=cuda is the step kernel B1, profiled in each of its forms in turn (the
resident form, one cooperative launch per chunk, where its plan holds the
shape; the per-half-step form, three launches per step); impl=stream the
stream kernel B2, in each of its forms in turn (the spill form, one
cooperative launch per chunk, where its plan holds the shape, e.g.
g-grid=20000; the tiling form, two launches per K steps). The shape
defaults to BASELINE #4 (N=100, M=4000), with its physics.
Needs a CUDA device; it fails without one.
"""

from __future__ import annotations

import subprocess
import sys
import time

# the kernels (and copies) whose device time counts as busy
KERNELS = ("half_step", "av_step", "record_step", "resident_chunk",
           "spill_chunk", "stream_tile", "stream_replay", "Memcpy")


def _device_us(evt):
    # the attribute was renamed across torch releases
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    pos = [a for a in argv if "=" not in a]
    n_steps = int(pos[0]) if pos else 2000
    dtype = pos[1] if len(pos) > 1 else "f32"
    impl = opts.get("impl", "cuda")
    N = int(opts.get("n-harmonics", 100))
    M = int(opts.get("g-grid", 4000))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from .config import SimConfig
    from .models.superlattice import SuperlatticeModel
    from .ops import stencil, stepper_cuda, stepper_stream_cuda
    from .runtime import schedule

    dev = torch.device("cuda:0")
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
                    alpha=0.9495, n_harmonics=N, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=10.0, g_grid=M,
                    dt=1e-3, dtype=dtype)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, dev)
    xs = next(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=100.0,
        t_start=0.0, E_omega=model.E_omega, display=4, frame_start=0.0,
        T=model.T, dtype=model.np_dtype, chunk_max=n_steps)).xs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    if impl == "stream":
        plan = stepper_stream_cuda.spill_plan(
            model.NHP, model.MP, model.np_dtype, stepper_cuda.card_sms(dev))
        runs = []
        for form in stepper_stream_cuda.FORMS:
            if form == "spill" and plan is None:
                continue
            runner = stepper_stream_cuda.make_stream_runner(c, model,
                                                            form=form)
            g, p = runner.geom, runner.plan
            runs.append((runner, (
                f"stream spill, {p.bands} bands, R={p.R}, S={p.S}, "
                f"{p.smem_bytes} B a block, slabs {p.spill_bytes} B" if p
                else f"stream tiling K={g.K} H={g.H} W={g.W}, {g.n_tiles} "
                     f"tiles, {'shared memory' if g.smem else 'global'}")))
    else:
        plan = stepper_cuda.resident_plan(model.NHP, model.MP,
                                          model.np_dtype,
                                          stepper_cuda.card_sms(dev))
        forms = [f for f in stepper_cuda.FORMS
                 if f != "resident" or plan is not None]
        runs = []
        for form in forms:
            runner = stepper_cuda.make_cuda_runner(c, model, form=form)
            p = runner.plan
            runs.append((runner, f"cuda-b1 {form}" + (
                f", {p.bands} bands of {p.W} columns, {p.smem_bytes} B a "
                f"block" if p else "")))
    for runner, how in runs:
        state = stencil.bootstrap_state(c, model)
        runner.run_xs(state, xs, 0)              # build, load, warm up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.run_xs(state, xs, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
                if _device_us(e) > 0 and e.count > 0]
        kernels = [r for r in rows if any(k in r[0] for k in KERNELS)]
        busy = sum(r[2] for r in kernels) * 1e-6
        print(f"profile_step: {n_steps} steps N={N} M={M} {dtype} [{how}], "
              f"wall {wall * 1e3:.3f} ms ({wall * 1e6 / n_steps:.2f} "
              f"us/step), device busy {busy * 1e3:.3f} ms "
              f"({busy * 1e6 / n_steps:.2f} us/step) = "
              f"{100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}% [{', '.join(card)}]")
        for key, count, us in sorted(kernels, key=lambda r: -r[2]):
            print(f"  {key[:60]:60s} x{count:6d} {us / 1e3:9.3f} ms "
                  f"{us / count:8.2f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
