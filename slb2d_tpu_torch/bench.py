"""The port's benchmark: lattice-site updates per second on one CUDA card.

    python -m slb2d_tpu_torch.bench [mode] [arguments]

Modes (the root bench.py's, on the port's engines):
  auto                 (default) the end-to-end driver at BASELINE #4
                       (N=100, M=4000, display 4, f32) with impl=auto
  driver [impl] [exact|fast] [display]
                       the driver (runtime/loop.Simulation) after
                       warmup(), best of 5 full runs, the state reset
                       between them; impl auto|torch|cuda|stream; fast =
                       exact-time=0
  cuda|stream|torch [M] [N]
                       a runner alone, av off, 20 chunks of 1000 steps
                       after one warm chunk: the step kernel (B1), the
                       temporal-tiling kernel (B2) or the plain tensor
                       step (device trig); the state is checked finite
                       after the clock
  f64 [M] [N]          the float64 engine impl=cuda takes (B1 in f64)
  sweep [torch|stack|lanes] [E_dc|omega]
                       the 64-point sweep at N=40 M=500, one drive period
                       per point: the batched torch engine, the stacked
                       sweep kernel (B3), or the lane-packed sweep kernel
                       (B4: one warm call, then one timed call of the
                       whole sweep)
  movie                not ported (display 7): an error line, exit 1

Each mode prints one JSON line: metric (its own per mode and arguments),
value, unit, device (the nvidia-smi name and power limit of the card),
wall_s, steps and the kernel launch counts of the mode's whole run,
warm-up included.  The site-update count is 2·(N+1)·(M+1)·steps (times
the points for a sweep).  Without a CUDA device, or on any exception (its
traceback goes to stderr first), the line has value null and an error,
and the exit code is 1.  No mode gives way to another engine when one
fails.

The bench functions take device= and their shapes, so that the tests can
run them small on the CPU; main() runs on cuda:0 only.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

UNIT = "updates/sec"

# BASELINE #4's physics (BASELINE.md; bench.py build and bench_driver)
PHYS = dict(E_dc=1.0, E_omega=2.0, mu=1.0, alpha=0.9495, phi_y_min=-10.0,
            phi_y_max=10.0, B=0.1, dt=1e-3)

# the sweep bench (BASELINE.md #2's shape): 64 points, N=40, M=500,
# t-max=0.1 (bench.py:177-195)
SWEEP_POINTS = 64


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sites(N, M, steps, points=1):
    return 2 * (N + 1) * (M + 1) * steps * points


def bench_runner(impl, chunk=1000, reps=20, N=100, M=4000, dtype="f32",
                 device=None):
    """A runner alone at the display-8 bench config of bench.py:88-111 (av
    off): impl 'cuda' (B1), 'stream' (B2) or 'torch' (stencil.fast_step,
    trig on the device from the carried t).  One warm chunk, then reps
    chunks timed to a synchronise; the state is checked finite after the
    clock.  Returns (updates/s, wall, steps, engine)."""
    import torch
    from .config import SimConfig
    from .models.superlattice import SuperlatticeModel
    from .ops import stencil

    cfg = SimConfig(display=8, omega=1.0, n_harmonics=N, t_start=10.0,
                    g_grid=M, impl=impl, dtype=dtype, **PHYS)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, device)
    state = stencil.bootstrap_state(c, model)
    if impl == "cuda":
        from .ops.stepper_cuda import make_cuda_runner
        run = make_cuda_runner(c, model, av_enabled=False)
    elif impl == "stream":
        from .ops.stepper_stream_cuda import make_stream_runner
        run = make_stream_runner(c, model, av_enabled=False)
    elif impl == "torch":
        def run(st, n):
            for _ in range(n):
                st = stencil.fast_step(c, st, av_enabled=False)
            return st
    else:
        raise ValueError(f"bench runner: unknown impl {impl!r}")
    state = run(state, chunk)                    # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = run(state, chunk)
    _sync(device)
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(state.a).all()):
        raise RuntimeError("bench runner: the state went non-finite")
    steps = chunk * reps
    return _sites(N, M, steps) / wall, wall, steps, impl


def bench_driver(impl="auto", N=100, M=4000, t_start=10.0, exact_time=True,
                 display=4, omega=1.0, reps=5, device=None):
    """The end-to-end driver: Simulation (schedule, chunked engine, the
    round-end fetch and the output write) after warmup(), best of reps
    full runs, the state and the round trackers reset between runs as
    bench.py:160-166 resets them.  Returns (updates/s, wall, steps,
    engine)."""
    from . import config as cfgmod
    from .ops import stencil
    from .runtime.loop import Simulation

    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfgmod.SimConfig(
            display=display, omega=omega, n_harmonics=N, t_start=t_start,
            g_grid=M, impl=impl, quiet=True, exact_time=exact_time,
            out_file=os.path.join(tmp, "obs.txt"), **PHYS)
        sim = Simulation(cfg, device=device)
        sim.warmup()
        wall = math.inf
        for rep in range(reps):
            if rep:
                sim.state = stencil.bootstrap_state(sim.c, sim.model)
                sim.t0 = sim.t_exit = 0.0
                sim.steps_done = 0
                sim.frame_time = sim.last_rem = 0.0
                sim.out = cfgmod.open_out(cfg)
            _sync(sim.device)
            t0 = time.perf_counter()
            sim.run()               # ends in the round-end fetch
            wall = min(wall, time.perf_counter() - t0)
    steps = sim.steps_done
    return _sites(N, M, steps) / wall, wall, steps, sim.engine_tag()


def sweep_params(B=SWEEP_POINTS, axis="E_dc", omega=1.0):
    """The swept grid of bench.py:177-182: E_dc over [0.1, 3.0], or omega
    over [0.8, 1.2] times the base omega."""
    if axis == "omega":
        return {"omega": omega * np.linspace(0.8, 1.2, B)}
    if axis != "E_dc":
        raise ValueError(f"sweep axis {axis!r}: E_dc or omega")
    return {"E_dc": np.linspace(0.1, 3.0, B)}


def make_sweep(B=SWEEP_POINTS, N=40, M=500, axis="E_dc", omega=1.0,
               t_start=0.1, device=None):
    """The sweep bench's ParameterSweep (f32, impl=auto: the bench drives
    each engine's runner itself)."""
    from .config import SimConfig
    from .parallel.sweep import ParameterSweep
    cfg = SimConfig(display=4, omega=omega, n_harmonics=N, t_start=t_start,
                    g_grid=M, quiet=True, **PHYS)
    return ParameterSweep(cfg, sweep_params(B, axis, omega), device=device)


def bench_sweep(sub="torch", axis="E_dc", B=SWEEP_POINTS, N=40, M=500,
                omega=1.0, t_start=0.1, K=None, reps=6, device=None):
    """Aggregate sweep throughput, after a warm call.  sub 'torch': the
    batched engine over reps timed calls of K steps (default 1000;
    bench.py:244-278); 'stack': B3 (SweepStackRunner) over one timed
    call of K steps (default 6144) after 512 (bench.py:185-221); 'lanes':
    B4 (make_sweep_lanes_runner, chunks of 16 points), one timed call of
    the whole sweep, host segment sums and state fetch included
    (bench.py:224-241).  Returns (updates/s, wall, steps, out): out is
    (sweep, the timed call's result) for 'lanes', else the final states."""
    import torch
    from .parallel import sweep as swmod
    sweep = make_sweep(B, N, M, axis, omega, t_start, device)
    dev = sweep.device
    if sub == "lanes":
        from .ops.sweep_lanes_cuda import make_sweep_lanes_runner
        runner = make_sweep_lanes_runner(sweep)
        runner()                                   # warm
        t0 = time.perf_counter()
        out = (sweep, runner())                    # ends in host arrays
        wall = time.perf_counter() - t0
        steps = sweep.n_steps
    elif sub == "stack":
        from .ops.sweep_stack_cuda import SweepStackRunner
        runner = SweepStackRunner(sweep)
        K = 6144 if K is None else K
        cap = sweep._zero_cap()

        def adv(st, k):
            nonlocal cap
            if runner.per_omega:
                st, cap = runner.advance(st, k, cap=cap)
                return st
            return runner.advance(st, k)

        states = adv(sweep._initial_states(), 512)    # warm
        _sync(dev)
        t0 = time.perf_counter()
        out = adv(states, K)
        _sync(dev)
        wall = time.perf_counter() - t0
        steps = K
    elif sub == "torch":
        K = 1000 if K is None else K
        weights, cap = sweep._weights(), sweep._zero_cap()
        out, cap = swmod._run_sweep(sweep.consts, sweep._initial_states(),
                                    cap, weights, K)      # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out, cap = swmod._run_sweep(sweep.consts, out, cap, weights, K)
        _sync(dev)
        wall = time.perf_counter() - t0
        steps = K * reps
    else:
        raise ValueError(f"sweep engine {sub!r}: torch, stack or lanes")
    if sub != "lanes" and not bool(torch.isfinite(out.a).all()):
        raise RuntimeError(f"sweep {sub}: the state went non-finite")
    return _sites(N, M, steps, sweep.B) / wall, wall, steps, out


def run_mode(argv, device, **depth):
    """The record of one mode (argv as on the command line, without the
    device line and launch counts); depth overrides the mode function's
    keyword arguments (shapes, reps, K), as the tests pass them."""
    mode = argv[0] if argv else "auto"
    args = argv[1:]
    if mode == "movie":
        raise NotImplementedError(
            "display 7 (movie) is not ported yet (ROADMAP.md queue A items "
            "3 and 5)")
    if mode in ("auto", "driver"):
        impl = "auto" if mode == "auto" else (args[0] if args else "auto")
        exact = not (mode == "driver" and len(args) > 1
                     and args[1] == "fast")
        display = int(args[2]) if mode == "driver" and len(args) > 2 else 4
        kw = dict(impl=impl, exact_time=exact, display=display, **depth)
        ups, wall, steps, engine = bench_driver(device=device, **kw)
        N, M = kw.get("N", 100), kw.get("M", 4000)
        what = ("end-to-end driver, BASELINE #4" if mode == "auto"
                else "driver")
        metric = (f"{what} site-updates/sec (N={N} M={M}, display="
                  f"{display}, impl={impl} [{engine}], "
                  f"{'exact' if exact else 'fast'}-time)")
    elif mode in ("cuda", "stream", "torch", "f64"):
        M = int(args[0]) if args else 4000
        N = int(args[1]) if len(args) > 1 else 100
        impl = "cuda" if mode == "f64" else mode
        dtype = "f64" if mode == "f64" else "f32"
        kw = dict(N=N, M=M, dtype=dtype, **depth)
        ups, wall, steps, _ = bench_runner(impl, device=device, **kw)
        name = {"cuda": "step kernel B1", "stream": "temporal-tiling kernel "
                "B2", "torch": "plain tensor step",
                "f64": "f64 engine of impl=cuda: step kernel B1 in "
                       "float64"}[mode]
        metric = (f"{mode} runner site-updates/sec (N={N} M={M}, {name}, "
                  f"av off)")
    elif mode == "sweep":
        sub = args[0] if args else "torch"
        axis = args[1] if len(args) > 1 else "E_dc"
        kw = dict(sub=sub, axis=axis, **depth)
        ups, wall, steps, _ = bench_sweep(device=device, **kw)
        name = {"torch": "batched torch engine", "stack": "stacked sweep "
                "kernel B3", "lanes": "lane-packed sweep kernel B4"}[sub]
        metric = (f"aggregate sweep site-updates/sec ({kw.get('B', 64)}-"
                  f"point {axis} sweep, N={kw.get('N', 40)} "
                  f"M={kw.get('M', 500)}, sweep {sub}: {name})")
    else:
        raise ValueError(f"unknown bench mode {mode!r}")
    return dict(metric=metric, value=ups, unit=UNIT, wall_s=wall,
                steps=steps)


def launch_counts():
    """Every kernel's launch count in this process (B1's also per form)."""
    from .ops import (stepper_cuda, stepper_stream_cuda, sweep_lanes_cuda,
                      sweep_stack_cuda)
    return {"B1": stepper_cuda.launch_count,
            "B1 resident": stepper_cuda.resident_launch_count,
            "B1 per-half-step": stepper_cuda.per_half_step_launch_count,
            "B2": stepper_stream_cuda.launch_count,
            "B3": sweep_stack_cuda.launch_count,
            "B3 per-omega": sweep_stack_cuda.omega_launch_count,
            "B4": sweep_lanes_cuda.launch_count}


def device_line():
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no device")
    return out[0]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv[0] if argv else "auto"
    card = None
    try:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench runs on a card "
                               "only")
        card = device_line()
        rec = run_mode(argv, "cuda:0")
        if not math.isfinite(rec["value"]):
            raise RuntimeError(f"non-finite rate {rec['value']}")
    except Exception as e:
        traceback.print_exc()
        print(json.dumps({"metric": "slb2d_tpu_torch bench "
                                    + (" ".join(argv) or mode),
                          "value": None, "unit": UNIT, "device": card,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    print(json.dumps({"metric": rec["metric"], "value": rec["value"],
                      "unit": UNIT, "device": card,
                      "wall_s": rec["wall_s"], "steps": rec["steps"],
                      "launches": launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
