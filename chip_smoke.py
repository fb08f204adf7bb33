#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slb2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (plus a few measurement lines):
  1. device:  requires CUDA; prints the card's name and power limit;
  2. build:   builds the CUDA kernels (csrc/stepper.cu, csrc/sweep_stack.cu)
              with one nvcc per source, all started together;
  3. kernel:  the step kernel against its plain PyTorch version on the
              card, 500 steps in two chunks (parity continuation) with
              display-77 records, at BASELINE #4 (N=100, M=4000) and at
              N=8 M=64, in f64 and f32;
  4. golden:  impl=cuda display 4 against the reference C solver's
              recorded output (tests/golden/d4_base1_*.txt);
  5. main:    the CLI (slb2d_tpu_torch.cli.main) at BASELINE #4, display 4,
              f32, impl=cuda, with the kernel launch count checked, and
              the plain path's rate beside the kernel's;
  6. sweep kernel: the sweep kernel against its plain version, 300 steps
              in two chunks, at the 64-point N=40 M=500 sweep shape and at
              a ragged 6-point shape with a dc-only point and mu swept, in
              f64 and f32; its time per step beside the plain version's;
  7. sweep main: the sweep CLI (slb2d_tpu_torch.sweep_cli.main) on the
              64-point E_dc sweep of bench.py's sweep bench, f32,
              impl=cuda, with the launch count, the table and every
              point's norm checked, and the batched torch engine's rate
              beside the kernel path's.
The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no ok line.  It needs no network and one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# BASELINE #4 (BASELINE.md; bench.py bench_driver): the flagship display-4 run
PHYS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
            phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3)
BASELINE4 = dict(n_harmonics=100, g_grid=4000)
SMALL = dict(n_harmonics=8, g_grid=64)
MAIN_ARGV = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1.0",
             "alpha=0.9495", "n-harmonics=100", "PhiYmin=-10",
             "PhiYmax=10", "B=0.1", "t-max=10", "dt=1e-3", "g-grid=4000",
             "dtype=f32", "impl=cuda", "quiet=1"]

# kernel vs plain: f64 is held to rounding differences (FMA contraction,
# reciprocal vs division, reduction order); f32 to tests/test_pallas.py's
# interpreter-vs-scan envelope (the same differences at float32, D7 class)
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=1e-4, atol=1e-7)}

# reference goldens at tests/test_golden.py's tolerances
GOLDENS = (("d4_base1_f64.txt", "f64", 1e-8, 1e-9),
           ("d4_base1_f32.txt", "f32", 2e-5, 8e-6))

# the one card the smoke run uses
DEVICE = "cuda:0"

KERNEL_SOURCE = "slb2d_tpu_torch/csrc/stepper.cu"
REPLACES = "slb2d_tpu/ops/stepper_pallas.py:133"
SWEEP_SOURCE = "slb2d_tpu_torch/csrc/sweep_stack.cu"
SWEEP_REPLACES = "slb2d_tpu/ops/sweep_stack.py:101"

# the 64-point E_dc sweep of bench.py:177-195 (bench_sweep_stack, BASELINE
# #2's shape): N=40 M=500 (NHP=48, MP=512), one drive period per point
SWEEP_FULL = dict(n_harmonics=40, g_grid=500, t_start=0.1)
SWEEP_POINTS = 64
SWEEP_ARGV = ["E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1.0",
              "alpha=0.9495", "n-harmonics=40", "PhiYmin=-10", "PhiYmax=10",
              "B=0.1", "t-max=0.1", "dt=1e-3", "g-grid=500", "dtype=f32",
              "impl=cuda", "quiet=1", "sweep:E_dc=0.1,3.0,64"]
# tests/test_sweep_stack.py's ragged grid: 6 points, point 2 dc-only
# (E_omega=0), mu swept so a0 varies per point
SWEEP_RAGGED = dict(n_harmonics=8, g_grid=24, t_start=0.2, omega=10.0)
RAGGED_PARAMS = {"E_omega": [2.0, 2.0, 0.0, 1.5, 2.0, 2.0],
                 "mu": [1.0, 1.2, 1.0, 0.8, 1.0, 1.1]}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def allclose(got, ref, rtol, atol, what):
    import torch
    got = got.double()
    ref = ref.double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(not bool(torch.isnan(got).any()), f"{what}: NaN")
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} entries outside rtol={rtol} "
          f"atol={atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def _setup(shape, dtype, device):
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.ops import stencil
    from slb2d_tpu_torch.runtime import schedule
    cfg = SimConfig(display=4, t_start=0.05, dtype=dtype, **PHYS, **shape)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, device)
    chunks = list(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=2.5,
        t_start=cfg.t_start, E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=10**9))
    return model, c, chunks[0].xs


def check_kernel_vs_plain(shape, dtype, n_steps=500):
    """Run the kernel and its plain version from one state over the same
    exact xs table, in two chunks (the first odd, so the second starts at
    parity 1), with display-77 records in both; raise on disagreement.
    Returns the largest abs difference of the state arrays."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    dev = torch.device(DEVICE)
    model, c, xs = _setup(shape, dtype, dev)
    n1 = n_steps // 2 + 1
    n2 = n_steps - n1
    parts = [({k: v[:n1] for k, v in xs.items()}, (0, 3, n1 // 2, n1 - 1)),
             ({k: v[n1:n_steps] for k, v in xs.items()},
              (1, n2 // 2, n2 - 1))]
    runner = stepper_cuda.make_cuda_runner(c, model)
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err = 0.0
    steps = 0
    for xs_part, emit in parts:
        launches0 = runner.launches
        kern = runner.run_xs(kern, xs_part, steps % 2, emit_idx=emit)
        table = stepper_cuda.pack_xs_dict(xs_part, model.np_dtype)
        plain, plain_obs = stepper_cuda.run_chunk_plain(
            c, plain, table, steps % 2, emit)
        torch.cuda.synchronize()
        n = len(xs_part["t"])
        steps += n
        check(runner.launches - launches0 == 3 * n + len(emit),
              f"launch count {runner.launches - launches0} for {n} steps")
        for f in ("a", "b", "a_hs", "b_hs"):
            err = max(err, allclose(getattr(kern, f), getattr(plain, f),
                                    what=f"{dtype} {shape} {f}", **tol))
        allclose(kern.av, plain.av, what=f"{dtype} {shape} av", **tol)
        for f in ("hs_edge_a", "hs_edge_b"):
            check(torch.equal(getattr(kern, f), getattr(plain, f)),
                  f"{dtype} {shape} {f} not bit for bit")
        check(int(kern.step) == int(plain.step) == steps, "step count")
        check(float(kern.t) == float(plain.t), "loop t")
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        check(torch.equal(obs[:, 4], ref[:, 4]), "record loop t")
        allclose(obs, ref, what=f"{dtype} {shape} d77 records", **tol)
    check(runner.launches > 0, "kernel never launched")
    return err


def time_per_step(fn, n_steps, reps=1):
    """ms per step of fn() (which runs n_steps), by CUDA events."""
    import torch
    fn()                                     # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * n_steps)


def kernel_ms(shape, dtype):
    """Per-step device time of the kernel at one shape, and its cost per
    extra chunk (host sync + table copy), measured as 2000 steps in one
    chunk vs in 20 chunks."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    dev = torch.device(DEVICE)
    model, c, xs = _setup(shape, dtype, dev)
    n = 2000
    win = {k: v[:n] for k, v in xs.items()}
    runner = stepper_cuda.make_cuda_runner(c, model)
    st = stencil.bootstrap_state(c, model)

    def kernel_one():
        runner.run_xs(st, win, 0)

    def kernel_many():
        for j in range(0, n, 100):
            runner.run_xs(st, {k: v[j:j + 100] for k, v in win.items()}, 0)

    k_ms = time_per_step(kernel_one, n, reps=3)
    many_ms = time_per_step(kernel_many, n, reps=3)
    chunk_ms = (many_ms - k_ms) * n / 19   # 19 extra chunks
    return k_ms, chunk_ms


def sweep_grid(shape):
    """(config keywords, params) of one sweep-kernel check shape."""
    import numpy as np
    if shape == "ragged":
        params = {"E_dc": np.linspace(0.3, 2.0, 6),
                  **{k: np.asarray(v) for k, v in RAGGED_PARAMS.items()}}
        return {**PHYS, **SWEEP_RAGGED}, params
    return ({**PHYS, **SWEEP_FULL},
            {"E_dc": np.linspace(0.1, 3.0, SWEEP_POINTS)})


def _sweep_setup(shape, dtype):
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.ops import sweep_stack_cuda
    from slb2d_tpu_torch.parallel.sweep import ParameterSweep
    kw, params = sweep_grid(shape)
    cfg = SimConfig(display=4, dtype=dtype, impl="cuda", quiet=True, **kw)
    sweep = ParameterSweep(cfg, params, device=torch.device(DEVICE))
    check(sweep.engine == "cuda", f"sweep engine {sweep.engine}, not cuda")
    return sweep, sweep_stack_cuda.SweepStackRunner(sweep)


def check_sweep_kernel_vs_plain(shape, dtype, n_steps=300):
    """Run the sweep kernel and its plain version from one batched state
    over the same exact tables, in two chunks (the first odd, so the
    second starts at parity 1); raise on disagreement.  Returns the
    largest abs difference of the state arrays."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    sweep, runner = _sweep_setup(shape, dtype)
    state0 = sweep._initial_states()
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = f"sweep {dtype} {shape} B={sweep.B}"
    dc_only = ~runner.egate
    err = 0.0
    n1 = n_steps // 2 + 1
    for n in (n1, n_steps - n1):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        launches0 = runner.launches
        kern = runner.advance(kern, n)
        plain = ssc.run_chunk_plain(sweep.consts, plain, xs, parity0,
                                    runner.egate)
        torch.cuda.synchronize()
        want = -(-n // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK
        check(runner.launches - launches0 == want,
              f"{what}: {runner.launches - launches0} launches for {n} "
              f"steps (expected {want})")
        for f in ("a", "b", "a_hs", "b_hs"):
            err = max(err, allclose(getattr(kern, f), getattr(plain, f),
                                    what=f"{what} {f}", **tol))
        allclose(kern.av, plain.av, what=f"{what} av", **tol)
        for f in ("hs_edge_a", "hs_edge_b"):
            check(torch.equal(getattr(kern, f), getattr(plain, f)),
                  f"{what} {f} not bit for bit")
        for st, name in ((kern, "kernel"), (plain, "plain")):
            check(bool(torch.all(st.av[dc_only] == 0)),
                  f"{what}: the dc-only point's av is not 0 ({name})")
        check(torch.equal(kern.step, plain.step), f"{what}: step count")
        check(torch.equal(kern.t, plain.t), f"{what}: loop t")
    if shape == "ragged":
        check(bool(dc_only.any()), "the ragged grid has no dc-only point")
    return err


def sweep_kernel_ms(n_kernel=1000, n_plain=30, n_engine=300):
    """ms per step of the sweep kernel (CUDA events, one launch for
    n_kernel steps), of its plain version and of the batched torch engine
    (host clock to a synchronise), at the 64-point shape in f32."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    from slb2d_tpu_torch.parallel import sweep as swmod
    sweep, runner = _sweep_setup("full", "f32")
    st = sweep._initial_states()
    xs = runner.chunk_table(n_plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssc.run_chunk_plain(sweep.consts, st.clone(), xs, 0, runner.egate)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    k_ms = time_per_step(lambda: runner.advance(st, n_kernel), n_kernel,
                         reps=2)
    cap = {k: torch.zeros(sweep.B, dtype=st.a.dtype, device=st.a.device)
           for k in swmod.CAP_KEYS}
    weights = sweep._weights()
    eng = sweep._initial_states()
    swmod._run_sweep(sweep.consts, eng, cap, weights, 2)    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swmod._run_sweep(sweep.consts, eng, cap, weights, n_engine)
    torch.cuda.synchronize()
    e_ms = (time.perf_counter() - t0) * 1e3 / n_engine
    return k_ms, p_ms, e_ms, sweep


def sweep_main_phase(card):
    """The sweep CLI on the 64-point sweep; returns (kernel launches, wall
    seconds, steps per point)."""
    import numpy as np
    import torch
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.ops import stepper_cuda, sweep_stack_cuda as ssc
    sweep, _ = _sweep_setup("full", "f32")
    steps = sweep.n_steps
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.txt")
        torch.cuda.synchronize()
        stepper_cuda.launch_count = 0
        ssc.launch_count = 0
        t0 = time.perf_counter()
        rc = sweep_cli.main(SWEEP_ARGV + [f"o={path}"])
        wall = time.perf_counter() - t0      # ends in the result fetch,
                                             # which synchronises
        launches = ssc.launch_count
        step_launches = stepper_cuda.launch_count
        check(rc == 0, f"sweep_cli.main returned {rc}")
        with open(path) as fh:
            text = fh.read()
    lines = text.splitlines()
    check(lines[0] + "\n" == sweep_cli.HEADER,
          f"sweep header {lines[0]!r}")
    rows = np.array([l.split() for l in lines[1:]], float)
    check(rows.shape == (SWEEP_POINTS, 15),
          f"expected {SWEEP_POINTS} 15-column lines, got {rows.shape}")
    check(bool(np.all(np.isfinite(rows))), "non-finite sweep output")
    check(np.allclose(rows[:, 0], np.linspace(0.1, 3.0, SWEEP_POINTS),
                      rtol=1e-11, atol=0), "the E_dc column")
    norm_err = float(np.max(np.abs(rows[:, 14] - 1.0)))
    check(norm_err < 1e-3, f"a point's norm is {norm_err} from 1")
    want = -(-steps // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK
    check(launches == want,
          f"{launches} sweep kernel launches for {steps} steps (expected "
          f"{want})")
    check(step_launches == 0, "the sweep path launched the step kernel")
    sites = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * steps * sweep.B
    print(f"sweep main: sweep_cli {SWEEP_POINTS}-point E_dc sweep N=40 "
          f"M=500 f32 impl=cuda: {steps} steps, {launches} launch(es), "
          f"max |norm-1| {norm_err:.3e}, wall {wall:.3f} s, "
          f"{sites / wall:.4e} site-updates/s [{card}]", flush=True)
    return launches, wall, steps


def ptxas_summary(log):
    """'kernel<type>: N registers[, spills]' for each compiled kernel."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(half_step|av_step|record_step|sweep_chunk)"
                          r"I([fd])(?:Lb([01]))?", m.group(1))
            name = (f"{k.group(1)}<{k.group(2)}"
                    f"{',' + k.group(3) if k.group(3) else ''}>"
                    if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and m.group(1) != "0":
            out.append(f"{name}: {m.group(1)} bytes spill stores")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers")
    return out


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0]


def golden_phase(card):
    import numpy as np
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.runtime.loop import Simulation
    for gold, dtype, rtol, atol in GOLDENS:
        with open(os.path.join(ROOT, "tests", "golden", gold)) as fh:
            gold_text = fh.read()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.txt")
            cfg = SimConfig(display=4, dtype=dtype, impl="cuda", quiet=True,
                            t_start=10.0, n_harmonics=20, g_grid=200,
                            out_file=path, **PHYS)
            Simulation(cfg, device=torch.device(DEVICE)).run()
            with open(path) as fh:
                mine = fh.read()

        def values(text):
            return [np.array(l.split(), float) for l in text.splitlines()
                    if l and not l.startswith("#")]

        gl, ml = values(gold_text), values(mine)
        check(len(gl) == len(ml) == 1, f"{gold}: line count")
        err = np.abs(ml[0] - gl[0])
        check(bool(np.all(err <= atol + rtol * np.abs(gl[0]))),
              f"{gold}: columns outside rtol={rtol} atol={atol}: "
              f"max abs err {err.max():.3e}")
        gh = [l for l in gold_text.splitlines() if l.startswith("#")]
        mh = [l for l in mine.splitlines() if l.startswith("#")]
        check(gh == mh, f"{gold}: header lines differ")
        print(f"golden {gold}: ok (max abs err {err.max():.3e}, "
              f"rtol {rtol}, atol {atol}) [{card}]", flush=True)


def main_path_phase(card):
    """The CLI at BASELINE #4; returns (launches, wall seconds, steps)."""
    import numpy as np
    import torch
    from slb2d_tpu_torch import cli
    from slb2d_tpu_torch.config import parse_cmd
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.ops import stepper_cuda
    from slb2d_tpu_torch.runtime import schedule

    model = SuperlatticeModel(parse_cmd(MAIN_ARGV))
    D = model.np_dtype
    steps = schedule.count_steps(0.0, float(D(D(10.0) + model.T)),
                                 model.dt, D)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "obs.txt")
        torch.cuda.synchronize()
        stepper_cuda.launch_count = 0
        t0 = time.perf_counter()
        rc = cli.main(MAIN_ARGV + [f"o={path}"])
        wall = time.perf_counter() - t0      # ends in the packed fetch,
                                             # which synchronises
        launches = stepper_cuda.launch_count
        check(rc == 0, f"cli.main returned {rc}")
        with open(path) as fh:
            text = fh.read()
    rows = [l.split() for l in text.splitlines()
            if l and not l.startswith("#")]
    check(len(rows) == 1 and len(rows[0]) == 13,
          f"expected one 13-column line, got {rows}")
    vals = np.array(rows[0], float)
    check(bool(np.all(np.isfinite(vals))), f"non-finite output {vals}")
    check(abs(vals[6] - 1.0) < 1e-3, f"NORM {vals[6]} not within 1e-3 of 1")
    check(launches == 3 * steps,
          f"{launches} kernel launches for {steps} steps (expected "
          f"{3 * steps})")
    sites = 2 * (model.N + 1) * (model.M + 1) * steps
    print(f"main: cli display=4 BASELINE#4 f32 impl=cuda: {steps} steps, "
          f"{launches} launches, NORM={vals[6]:.9f}, wall {wall:.3f} s, "
          f"{sites / wall:.4e} site-updates/s [{card}]", flush=True)
    return launches, wall, steps


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import slb2d_tpu_torch
    pkg = os.path.dirname(os.path.abspath(slb2d_tpu_torch.__file__))
    check(pkg == os.path.join(ROOT, "slb2d_tpu_torch"),
          f"slb2d_tpu_torch imported from {pkg}, not from this checkout")
    from slb2d_tpu_torch.ops import _build, stencil, stepper_cuda

    # 1. device: the nvidia-smi line (name, power limit) on its own line
    card = gpu_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    secs = time.perf_counter() - t0
    how = (f"built in {lib.build_seconds:.2f} s" if lib.build_seconds
           else "an earlier build of these sources")
    print(f"build: nvcc sm_90a {os.path.relpath(lib.path, ROOT)}: {how} "
          f"(load {secs:.2f} s); ptxas: "
          f"{' | '.join(ptxas_summary(lib.build_log))}", flush=True)

    # 3. kernel vs plain on the card
    max_err = {}
    for shape_name, shape in (("BASELINE#4", BASELINE4), ("N8M64", SMALL)):
        for dtype in ("f64", "f32"):
            max_err[shape_name, dtype] = check_kernel_vs_plain(shape, dtype)
    print("kernel: vs plain, 500 steps in 2 chunks + d77 records: " +
          ", ".join(f"{s} {d} max abs err {e:.3e}"
                    for (s, d), e in max_err.items()) + " ok", flush=True)
    k_ms, chunk_ms = kernel_ms(BASELINE4, "f32")
    print(f"kernel time BASELINE#4 f32: {k_ms:.5f} ms/step (3 launches, "
          f"CUDA events), extra chunk {chunk_ms:.4f} ms [{card}]",
          flush=True)

    # 4. goldens through impl=cuda
    golden_phase(card)

    # 5. the main path, then the plain path's rate over 2000 steps
    from slb2d_tpu_torch.ops import sweep_stack_cuda
    sweep_stack_cuda.launch_count = 0
    launches, wall, steps = main_path_phase(card)
    check(sweep_stack_cuda.launch_count == 0,
          "the single-run path launched the sweep kernel")
    model, c, xs = _setup(BASELINE4, "f32", torch.device(DEVICE))
    win = {k: v[:2000] for k, v in xs.items()}
    st = stencil.bootstrap_state(c, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stencil.run_chunk(c, st, win, collect_obs=False)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    p_ms = plain_wall * 1e3 / 2000
    per_step = 2 * (model.N + 1) * (model.M + 1)
    print(f"main: plain torch path, 2000 steps at BASELINE#4 f32: "
          f"{plain_wall:.3f} s ({p_ms:.5f} ms/step), "
          f"{per_step * 2000 / plain_wall:.4e} site-updates/s; kernel path "
          f"{per_step * steps / wall:.4e} [{card}]", flush=True)

    # 6. the sweep kernel against its plain version, and its times
    sweep_err = {}
    for shape in ("full", "ragged"):
        for dtype in ("f64", "f32"):
            sweep_err[shape, dtype] = check_sweep_kernel_vs_plain(shape,
                                                                  dtype)
    print("sweep kernel: vs plain, 300 steps in 2 chunks, edges bit for "
          "bit, dc-only av 0: " +
          ", ".join(f"{s} {d} max abs err {e:.3e}"
                    for (s, d), e in sweep_err.items()) + " ok", flush=True)
    sk_ms, sp_ms, se_ms, sweep = sweep_kernel_ms()
    per_step = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * sweep.B
    print(f"sweep kernel time {SWEEP_POINTS}-point N=40 M=500 f32: kernel "
          f"{sk_ms:.5f} ms/step (1 launch per chunk, CUDA events), plain "
          f"version {sp_ms:.5f} ms/step, batched torch engine "
          f"{se_ms:.5f} ms/step = {per_step / (se_ms * 1e-3):.4e} "
          f"site-updates/s (host clock) [{card}]", flush=True)

    # 7. the sweep main path
    sweep_launches, sweep_wall, sweep_steps = sweep_main_phase(card)

    print(json.dumps({"kernels": [{
        "name": "slb_run_chunk (half_step<MAIN>, half_step<HALF>, av_step)",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err["BASELINE#4", "f32"],
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "slb_sweep_chunk (sweep_chunk)",
        "route": "cuda", "source": SWEEP_SOURCE, "replaces": SWEEP_REPLACES,
        "launches": sweep_launches,
        "max_abs_err": sweep_err["full", "f32"],
        "ms": sk_ms, "plain_ms": sp_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
