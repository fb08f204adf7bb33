#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slb2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (plus a few measurement lines):
  1. device:  requires CUDA; prints the card's name and power limit;
  2. build:   builds the CUDA step kernel (csrc/stepper.cu) with nvcc;
  3. kernel:  the kernel against its plain PyTorch version on the card,
              500 steps in two chunks (parity continuation) with
              display-77 records, at BASELINE #4 (N=100, M=4000) and at
              N=8 M=64, in f64 and f32;
  4. golden:  impl=cuda display 4 against the reference C solver's
              recorded output (tests/golden/d4_base1_*.txt);
  5. main:    the CLI (slb2d_tpu_torch.cli.main) at BASELINE #4, display 4,
              f32, impl=cuda, with the kernel launch count checked, and
              the plain path's rate beside the kernel's.
The last two lines are a JSON record of the kernel and
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
    regs = [l.strip() for l in lib.build_log.splitlines()
            if "registers" in l]
    how = (f"built in {lib.build_seconds:.2f} s" if lib.build_seconds
           else "an earlier build of these sources")
    print(f"build: nvcc sm_90a {os.path.relpath(lib.path, ROOT)}: {how} "
          f"(load {secs:.2f} s); ptxas: {' | '.join(regs)}", flush=True)

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
    launches, wall, steps = main_path_phase(card)
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

    print(json.dumps({"kernels": [{
        "name": "slb_run_chunk (half_step<MAIN>, half_step<HALF>, av_step)",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err["BASELINE#4", "f32"],
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
