"""Where a sweep's time goes on the card: the 64-point E_dc sweep of
bench.py's sweep bench (N=40, M=500, f32, one drive period per point) on
the sweep kernel, stage by stage, with the device's busy and idle share
of the run under torch.profiler, the kernel's time per step as the point
count grows in both of its forms, and the lane-packed sweep kernel's
whole run (the bench's `sweep lanes`) under the profiler in chunks of 16
points and in one chunk of 64.

    python -m slb2d_tpu_torch.profile_sweep [points ...]

The points (default 16 32 64 66 128 132 256) give the scaling lines: the
cluster form (the one the sweep runs) takes a cluster of 2 blocks a
point, one block an SM, so the card holds as many points at once as it
runs clusters (printed) and more points run in waves; the streaming
form, timed in turns with it, takes one block a point.  Needs a CUDA
device; it fails without one.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np

from .profile_step import _device_us


def _sweep(n_points, dev, dtype="f32"):
    from .config import SimConfig
    from .parallel.sweep import ParameterSweep
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
                    alpha=0.9495, n_harmonics=40, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=0.1, g_grid=500,
                    dt=1e-3, impl="cuda", dtype=dtype, quiet=True)
    return ParameterSweep(cfg, {"E_dc": np.linspace(0.1, 3.0, n_points)},
                          device=dev)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    points = [int(a) for a in argv] or [16, 32, 64, 66, 128, 132, 256]
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_sweep: no CUDA device", file=sys.stderr)
        return 1
    from .ops import sweep_stack_cuda

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    _sweep(2, dev).run()                       # build, load, warm up
    torch.cuda.synchronize()

    # stage by stage, then the whole run under the profiler
    t0 = time.perf_counter()
    sweep = _sweep(64, dev)
    t1 = time.perf_counter()
    states = sweep._initial_states()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    runner = sweep_stack_cuda.SweepStackRunner(sweep)
    xs = runner.chunk_table(sweep.n_steps)
    t3 = time.perf_counter()
    states = runner.advance(states, sweep.n_steps)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    print(f"profile_sweep: 64 points x {sweep.n_steps} steps f32: models "
          f"and consts {(t1 - t0) * 1e3:.3f} ms, bootstrap "
          f"{(t2 - t1) * 1e3:.3f} ms, runner and table "
          f"{(t3 - t2) * 1e3:.3f} ms ({xs.shape[0]} rows), advance "
          f"{(t4 - t3) * 1e3:.3f} ms [{', '.join(card)}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sweep(64, dev).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if _device_us(e) > 0 and e.count > 0]
    busy = sum(r[2] for r in rows) * 1e-6
    print(f"  run(): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms = {100 * busy / wall:.1f}%, idle "
          f"{100 * (1 - busy / wall):.1f}%")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:6]:
        print(f"  {key[:60]:60s} x{count:6d} {us / 1e3:9.3f} ms")

    # kernel time per step against the point count (CUDA events), the
    # plan's form and the streaming form in turns; f64 at 64 and 256
    # points
    n = 1000
    for b, dtype in [(b, "f32") for b in points] + [(64, "f64"),
                                                     (256, "f64")]:
        sw = _sweep(b, dev, dtype)
        runners = (sweep_stack_cuda.SweepStackRunner(sw),
                   sweep_stack_cuda.SweepStackRunner(sw, cluster_size=0))
        st = sw._initial_states()
        for r in runners:
            r.advance(st, 10)
        us = {r: [] for r in runners}
        for r in runners + runners[::-1]:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            r.advance(st, n)
            stop.record()
            torch.cuda.synchronize()
            us[r].append(start.elapsed_time(stop) / n * 1e3)
        clu, stm = runners
        info = sweep_stack_cuda.form_info(sw.base.np_dtype, False,
                                          clu.cluster_size, sw.base.NHP,
                                          sw.base.MP)
        sites = 2 * (sw.base.N + 1) * (sw.base.M + 1) * b
        best = min(us[clu])
        print(f"  {b:4d} points {dtype}: {clu.form} CS={clu.cluster_size} "
              f"({info['active_clusters']} clusters at once) "
              f"{', '.join(f'{v:.2f}' for v in us[clu])} us/step, "
              f"{sites / (best * 1e-6):.4e} site-updates/s; streaming "
              f"{', '.join(f'{v:.2f}' for v in us[stm])} us/step")

    # the lane-packed kernel's whole sweep (runner(), host sums included)
    from .ops.sweep_lanes_cuda import make_sweep_lanes_runner
    for max_points in (16, 64):
        runner = make_sweep_lanes_runner(sweep, max_points=max_points)
        runner()                                   # build, warm up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, _device_us(e))
                for e in prof.key_averages()
                if _device_us(e) > 0 and e.count > 0]
        busy = sum(r[2] for r in rows) * 1e-6
        print(f"  lanes max_points={max_points} ({len(runner.packs)} "
              f"chunk(s), {runner.form} form CS={runner.cluster_size}), "
              f"runner(): wall {wall * 1e3:.3f} ms "
              f"({wall / sweep.n_steps * 1e6:.2f} us/step), device busy "
              f"{busy * 1e3:.3f} ms = {100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%")
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:4]:
            print(f"    {key[:58]:58s} x{count:6d} {us / 1e3:9.3f} ms "
                  f"({us / count:.2f} us each)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
