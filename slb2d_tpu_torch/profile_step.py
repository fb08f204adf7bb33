"""Where a step's time goes on the card: the kernel path at BASELINE #4
(N=100, M=4000) under torch.profiler, per CUDA kernel, with the device's
busy and idle share of the window's wall time.

    python -m slb2d_tpu_torch.profile_step [n_steps] [f32|f64]

Needs a CUDA device; it fails without one.
"""

from __future__ import annotations

import subprocess
import sys
import time


def _device_us(evt):
    # the attribute was renamed across torch releases
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    n_steps = int(argv[0]) if argv else 2000
    dtype = argv[1] if len(argv) > 1 else "f32"
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from .config import SimConfig
    from .models.superlattice import SuperlatticeModel
    from .ops import stencil, stepper_cuda
    from .runtime import schedule

    dev = torch.device("cuda:0")
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
                    alpha=0.9495, n_harmonics=100, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=10.0, g_grid=4000,
                    dt=1e-3, dtype=dtype)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, dev)
    xs = next(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=100.0,
        t_start=0.0, E_omega=model.E_omega, display=4, frame_start=0.0,
        T=model.T, dtype=model.np_dtype, chunk_max=n_steps)).xs
    runner = stepper_cuda.make_cuda_runner(c, model)
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
    kernels = [r for r in rows if "half_step" in r[0] or "av_step" in r[0]
               or "record_step" in r[0] or "Memcpy" in r[0]]
    busy = sum(r[2] for r in kernels) * 1e-6
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    print(f"profile_step: {n_steps} steps BASELINE#4 {dtype}, wall "
          f"{wall * 1e3:.3f} ms ({wall * 1e6 / n_steps:.2f} us/step), "
          f"device busy {busy * 1e3:.3f} ms = {100 * busy / wall:.1f}%, "
          f"idle {100 * (1 - busy / wall):.1f}% [{', '.join(card)}]")
    for key, count, us in sorted(kernels, key=lambda r: -r[2]):
        print(f"  {key[:60]:60s} x{count:6d} {us / 1e3:9.3f} ms "
              f"{us / count:8.2f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
