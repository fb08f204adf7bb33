#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slb2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (plus a few measurement lines):
  1. device:  requires CUDA; prints the card's name and power limit;
  2. build:   builds the CUDA kernels (csrc/stepper.cu, csrc/sweep_stack.cu
              with both modes of the sweep kernel, csrc/stepper_stream.cu)
              with one nvcc per source, all started together;
  3. kernel:  the step kernel B1 in both forms (resident, per-half-step)
              against its plain PyTorch version on the card, 500 steps
              in two chunks (parity continuation) with display-77
              records, at BASELINE #4 (N=100, M=4000) and at N=8 M=64, in
              f64 and f32, and 200 steps at N=400 M=4000 and N=100
              M=12000 in f32 (state and edges bit for bit, one launch a
              chunk on the resident form); the resident form against the
              per-half-step form over 203 steps at the three f32 shapes,
              bit for bit; what the resident form takes on the card
              (band, registers, spills, shared bytes, blocks at once);
              its fixed cost per step (N=7 M=4000, in turns with the
              per-half-step form); B1's cell code in SASS (half_step
              whole, the resident kernel's cell loops);
  4. golden:  impl=cuda display 4 against the reference C solver's
              recorded output (tests/golden/d4_base1_*.txt);
  5. main:    the CLI (slb2d_tpu_torch.cli.main) at BASELINE #4, display 4,
              f32, impl=cuda (on the engine and B1 form the routing
              picks), with the kernel launch counts checked per engine
              and B1 form, and the plain path's rate beside the
              kernel's;
  6. sweep kernel: the sweep kernel (B3) against its plain version, 300
              steps in two chunks, at the 64-point N=40 M=500 sweep shape
              and at a ragged 6-point shape with a dc-only point and mu
              swept, in f64 and f32, on the cluster form cluster_plan
              picks (state and edges bit for bit); what each form takes
              on the card (registers, spills, shared memory, clusters at
              once) at both shapes for every cluster size that holds a
              point; its time per step in the cluster and the streaming
              form, in turns, beside the plain version's;
  7. sweep main: the sweep CLI (slb2d_tpu_torch.sweep_cli.main) on the
              64-point E_dc sweep of bench.py's sweep bench, f32,
              impl=cuda, with the launch counts (per mode and per form:
              the cluster form), the table and every point's norm
              checked, and the batched torch engine's rate beside the
              kernel path's;
  8. omega kernel: the sweep kernel's per-omega mode against its plain
              version with the frames capture on, in two chunks (151
              steps, then the rest from parity 1), on the ragged 5-point
              omega grid (a dc-only point) and on 16 omegas x 4 E_dc at
              N=40 M=500, each run to its end so every point's loop-exit
              capture fires, in f64 and f32, and on the 16 x 16 paper map
              from step 4990 across its window start and first exits, in
              f32 (cluster form; state, edges and frames bit for bit);
              its time per step over the whole sweep in both forms, in
              turns, beside the plain version's and the batched torch
              engine's;
  9. omega sweep: the 16 x 4 grid at t-max=0.05 through the per-omega
              kernel against the batched torch engine on the card (av
              counts exact, observables at 2e-4 rel / 2e-5 abs);
 10. omega main: the sweep CLI on the 16 x 16 paper absorption map
              (examples/absorption_map.py paper), f32, impl=cuda: launch
              counts (the cluster form), 256 finite lines, norms, every
              point's av count against the host schedule; then the
              measurement behind impl=auto's routing of omega sweeps to
              the kernel: the kernel path end to end against the batched
              engine's time per step, at the 64-point omega sweep of
              bench.py and at the paper map;
 11. frames:  sweep_cli frames-dir= on the card, a shared-omega grid
              through the kernel and an omega grid through the per-omega
              kernel (impl=cuda and impl=auto) and through the batched
              engine (impl=torch), the kernel's frames against the
              batched engine's;
 12. stream kernel: the temporal-tiling kernel (B2) against its plain
              version, K+3 steps (a full launch and a partial one) then 5
              from parity 1, with display-77 records, at N=100 M=12000 and
              N=400 M=4000 in f32 and at N=8 M=64 and N=18 M=300 in f64
              (state and edges bit for bit, av and records at TOL); then B2
              against B1 over 203 steps at both shapes (state bit for bit);
              its time per step beside the plain version's; then B2's
              spill form against its plain version (B1's), 200 steps in
              two chunks with display-77 records, at N=100 M=20000 f32
              (its plan: 132 bands, R=128) and at N=8 M=64 and N=13 M=300
              in f32 and f64 through forced plans of 2 and 5 bands (every
              band spills), state and edges bit for bit, av and records at
              TOL; the spill form against the tiling form and B1's
              per-half-step form over 203 steps at N=100 M=20000, bit for
              bit;
 13. stream golden: impl=stream display 4 against d4_base1_*.txt, and
              display 77 on impl=cuda and impl=stream against the patched
              reference's d77_tiny_*_fixed.txt.gz (the tiling form); then
              display 4 and 77 on the spill form through forced plans;
 14. stream main: the CLI at N=100 M=12000 and N=400 M=4000 (BASELINE
              #4's physics, 16,281 steps) with impl=stream and impl=cuda,
              display 4 (launch counts checked per engine and B1 form,
              the 13 columns of B2 against B1, and at N=400 M=4000 of
              B1's resident against its per-half-step form) and display
              77 with impl=stream; display 77 against display 4 at
              BASELINE #4 on B1;
 15. stream routing: B1 resident, B1 per-half-step and B2 per step at
              the three shapes, in turns, the measurement behind
              impl=cuda's and auto's engine choice; then B2 on its own
              main path, N=100 M=20000 f32 (the first shape past B1's
              resident plan): impl=cuda routes it to B2's spill form, the
              CLI there with its launches (one per chunk), the spill form,
              the tiling form and B1's per-half-step form per step in
              turns, the bound and each one's loss; what the spill form
              takes on the card (the one-off measurements behind the
              spill plan's budget, the tiling form's width and the f64
              routing are python -m slb2d_tpu_torch.perf.stream_forms);
 16. lanes kernel: the lane-packed sweep kernel (B4) in both forms (the
              cluster form lanes_cluster_plan picks, and the streaming
              form) against its plain version, its steps split across
              calls at step 151, on tests/test_sweep_pallas.py's 3-point
              grid (a dc-only point) and the ragged omega grid, both run
              to their ends (every window edge and capture), and on the
              64-point E_dc sweep for 300 steps with max_points=16 and in
              one chunk of 64 (state, per-lane rows and segment sums bit
              for bit); the cluster form against the streaming form over
              the whole 64-point sweep in chunks of 16 and of 64, bit for
              bit; what each form takes on the card (cluster size,
              registers, spills, shared bytes, clusters at once); the
              plan's cluster size against the others (clusters at once
              by size, the sweep's time per step at each, in turns); the
              fixed cost of a step (16 points at N=6 M=29); both forms'
              time per step over the whole sweep in turns, in chunks of
              16 and in one of 64, beside the plain version's;
              the bench's runner() (a fetch after each chunk) against the
              same chunks all enqueued before the first fetch, in turns;
 17. lanes main: `python -m slb2d_tpu_torch.bench sweep lanes` as a
              subprocess (its JSON line, device line and B4 launch
              count: one per chunk call on the cluster form), then the
              bench function in this process (its launches by form):
              every point's av count against the schedule, the
              observables against the stacked sweep kernel B3's on the
              same sweep, and B4's wall and time per step beside B3's;
 18. bench modes: every other mode of the bench once (auto, driver cuda
              exact 4 and driver stream exact 77 as subprocesses, driver
              torch fast 4 at a small shape, cuda, stream, f64, torch 400
              20, sweep torch, sweep stack, sweep stack omega; the plain
              engines' modes at a cut depth), each one parseable line with
              a finite value and B1's launches per form where it ran
              B1, and movie refused with exit 1;
 19. P1:      the float32 chain kernel (csrc/probe_vpu.cu) against its
              plain version at the probe's 104 x 4160, 3 turns, mul+add
              and fma at every (ILP, block) pair it was built for, bit for
              bit; the SASS of each instance (its turn loop FMUL + FADD, or
              FFMA, and the loop control alone); then the probe's main
              path (perf/vpu_roofline.run at 2000 turns, each variant at
              its pair in vpu_roofline.CHOSEN) with its launches, the SM
              clock sampled beside it: its rate as a share of the data
              sheet's and of the FP32 pipes' at that clock;
 20. P2:      the roll kernels (csrc/probe_roll.cu: registers, every line
              in registers with a shuffle and a halo exchanged every T
              passes; one launch per pass) against the plain version at
              2 x 104 x 4096, 5 and 100 passes (three halo refreshes),
              both forms and axes, bit for bit; then the probe's main
              path (perf/roll_cost_experiment.run) with its launches: us
              per pass, stacked against split;
 21. P3:      the transposed step kernel (csrc/probe_transposed.cu) in
              both forms (resident: one cooperative launch a chunk;
              per-half-step: two launches a step) against its plain
              version, B1's plain version (av off), at BASELINE #4, 200
              steps in two chunks (the second from parity 1), bit for
              bit; then the probe's main path
              (perf/transposed_experiment.run: 1000 steps on both forms
              and both forms of B1, every state bit for bit, the four
              timed in turns) with its launches per form; what each
              form takes on the card against the resident plan;
 22. forms vs: B3's cluster form against its streaming form over the
              whole 64-point sweep and the whole paper map, f32: state and
              edges (and the map's frames) bit for bit, av and captures at
              TOL;
 23. streaming: B3's streaming form where no cluster holds a point, 8
              points at N=100 M=4000 f32, against its plain version (an
              E_dc sweep 300 steps, an omega sweep to its end with
              frames).
The last lines are the operation counts and bounds of the main paths, a
JSON record of the kernels (ms, plain_ms and bound_ms per step, per turn
for P1, per pass for P2; B1's with its form, band, blocks, threads,
shared bytes, registers, spills, blocks at once, barrier_us (its fixed
cost per step), ms_per_half_step (the per-half-step form's time in the
same run), the three engines' times in turns and its SASS counts; B3's
with its form, cluster size, shared bytes, registers, clusters at once
and ms_streaming, the streaming form's time in the same run; B4's with
the same and its spills, its times in one chunk of 64 and the runner's
walls; B2's tiling form's at the wide grid and its spill form's
at N=100 M=20000 with phase 15's measurements;
bound_ms is the larger of the main path's
operations at F32_OPS_PEAK, the data sheet's, and its bytes, each input
read once and each output written once, at 3.35 TB/s, over its steps;
bound_ms_at_p1_rate the same at the rate P1 measured) and
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no ok line.  It needs no network and one card.
"""

from __future__ import annotations

import contextlib
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

# sweep observables compared between engines
OBS = ("v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin", "v_dr_inst",
       "v_y_inst", "m_over_m_x_inst", "norm", "av_count")

# reference goldens at tests/test_golden.py's tolerances
GOLDENS = (("d4_base1_f64.txt", "f64", 1e-8, 1e-9),
           ("d4_base1_f32.txt", "f32", 2e-5, 8e-6))

# the one card the smoke run uses
DEVICE = "cuda:0"

KERNEL_SOURCE = "slb2d_tpu_torch/csrc/stepper.cu"
REPLACES = "slb2d_tpu/ops/stepper_pallas.py:133"
SWEEP_SOURCE = "slb2d_tpu_torch/csrc/sweep_stack.cu"
SWEEP_REPLACES = "slb2d_tpu/ops/sweep_stack.py:101"
STREAM_SOURCE = "slb2d_tpu_torch/csrc/stepper_stream.cu"
STREAM_REPLACES = "slb2d_tpu/ops/stepper_stream.py:85"
LANES_SOURCE = "slb2d_tpu_torch/csrc/sweep_lanes.cu"
LANES_REPLACES = "slb2d_tpu/ops/sweep_pallas.py:50"
# the tests/perf probes P1-P3 (slb2d_tpu_torch/perf/)
VPU_SOURCE = "slb2d_tpu_torch/csrc/probe_vpu.cu"
VPU_REPLACES = "tests/perf/vpu_roofline.py:60"
ROLL_SOURCE = "slb2d_tpu_torch/csrc/probe_roll.cu"
# each kernel runs both forms: _kernel_two (:35) and _kernel_one (:47)
ROLL_REPLACES = "tests/perf/roll_cost_experiment.py:35"
ROLL_REPLACES_ONE = "tests/perf/roll_cost_experiment.py:47"
TRANSPOSED_SOURCE = "slb2d_tpu_torch/csrc/probe_transposed.cu"
TRANSPOSED_REPLACES = "tests/perf/transposed_experiment.py:73"

# the stream engine's shapes (docs/PERF.md "HBM-streaming engine"): the
# wide grid N=100 M=12000 (NHP=104, MP=12032) and the tall-thin N=400
# M=4000 (NHP=408, MP=4096), at BASELINE #4's physics
WIDE = dict(n_harmonics=100, g_grid=12000)
TALL = dict(n_harmonics=400, g_grid=4000)
# B2's spill form at small shapes through forced plans (few bands, narrow
# resident parts, so that every band spills): (name, shape, dtype, bands,
# R).  N=13 M=300 (NHP=16, MP=384): 5 bands of 76-77 columns, 12-13 of
# them spilled, column M+1 = 301 in band 3's slab
SPILL_FORCED = (("N=8 M=64", SMALL, "f32", 2, 32),
                ("N=8 M=64", SMALL, "f64", 2, 32),
                ("N=13 M=300", dict(n_harmonics=13, g_grid=300), "f32", 5,
                 64),
                ("N=13 M=300", dict(n_harmonics=13, g_grid=300), "f64", 5,
                 64))
D77_GOLDENS = (("d77_tiny_f32_fixed.txt.gz", "f32", 2e-4, 8e-6),
               ("d77_tiny_f64_fixed.txt.gz", "f64", 5e-9, 1e-12))

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

# tests/test_sweep_stack.py's ragged omega grid (OMEGA_PARAMS: 5 points,
# distinct periods, point 2 dc-only) with t-max cut to 0.01, so a run of
# the whole sweep (796 steps) crosses every point's loop exit
OMEGA_RAGGED = dict(n_harmonics=8, g_grid=24, t_start=0.01, omega=10.0)
OMEGA_RAGGED_PARAMS = {"omega": [8.0, 10.0, 12.0, 14.0, 10.0],
                       "E_dc": [0.4, 0.75, 1.1, 1.45, 1.8],
                       "E_omega": [2.0, 2.0, 0.0, 1.5, 2.0]}
# the absorption-map point shape (examples/absorption_map.py paper; N=40,
# M=500, E_omega=1.5): the paper's 16 omegas x 4 E_dc at one drive period
# (tests/test_sweep_stack.py:303-337), and the 16 x 16 paper map itself
MAP = dict(E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0, alpha=0.9495,
           phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3, n_harmonics=40,
           g_grid=500)
PAPER_ARGV = ["E_dc=0.0", "E_omega=1.5", "omega=1.0", "mu=1.0",
              "alpha=0.9495", "n-harmonics=40", "PhiYmin=-10", "PhiYmax=10",
              "B=0.1", "t-max=5", "dt=1e-3", "g-grid=500", "dtype=f32",
              "impl=cuda", "quiet=1", "sweep:E_dc=0,3,16",
              "sweep:omega=6,14,16"]
PAPER_POINTS = 256
# tests/test_sweep_pallas.py's grid: 3 points (E_dc swept, point 2
# dc-only) at N=6 M=29, omega=20, t-max=0.02 (335 steps)
LANES3 = dict(E_dc=1.0, E_omega=2.0, omega=20.0, mu=1.0, alpha=0.9495,
              n_harmonics=6, phi_y_min=-5.0, phi_y_max=5.0, B=0.1,
              t_start=0.02, g_grid=29, dt=1e-3)
LANES3_PARAMS = {"E_dc": [0.5, 1.25, 2.0], "E_omega": [2.0, 2.0, 0.0]}
# the bench's sweep lanes mode: chunks of max_points=16 (the JAX runner's
# default) points
LANES_MAX_POINTS = 16
# bench.py:177-182's omega sweep: omega = linspace(0.8, 1.2, 64) at the
# 64-point E_dc sweep's config (t-max=0.1, one period, ~7,950 steps)
OMEGA64_ARGV = SWEEP_ARGV[:-1] + ["sweep:omega=0.8,1.2,64"]
# sweeps of points past cluster residency, on B3's streaming form: 8
# points at BASELINE #4's N=100 M=4000 (6.8 MB a point in float), E_dc
# swept, and 8 omegas (periods 0.21-0.31, t-max=0.01, so a run to the end,
# 321 steps, crosses every loop exit)
WIDE8 = dict(t_start=0.1, **BASELINE4)
OMEGA_WIDE8 = dict(t_start=0.01, **BASELINE4)
# the ragged grids' points at the sweeps' N=40 M=500 (NHP=48, MP=512),
# where a cluster of 2 (float) or 4 (double) blocks is the smallest to
# hold a point
GRID40 = dict(n_harmonics=40, g_grid=500)

# The least time the card could take for a main path's kernel work
# (bound_ms).  Its operations are the floating-point adds, multiplies and
# divisions the function needs, counted from csrc/half_step.cuh with each
# per-column or per-row term taken once per column or row, each loop
# invariant (dt·a0, B·phi[m]) once per run, and each neighbour difference
# once (it serves the rows above and below).  Per live cell of a
# half-step: mu_t and mu_t1 from their column's coefficients 2, one a and
# one b difference 2, g 7, h 6, xi 2, 1/xi 1, a 4, b 4.  The live cells
# are rows 0..N-1 (row N stays 0) by columns 1..M+1 of the main grid and
# 1..M of the half grid.
CELL_FLOPS = 28
# per column of a half-step: the coefficients (E_dc + E_omega·cos +
# B·phi[m])·dt/2 of cos_t and of cos_t_dt, 2 each; per point and step:
# E_dc + E_omega·cos for the four cos values, 2 each
COLUMN_FLOPS = 4
STEP_FLOPS = 8
# per averaging step of a point: three weighted sums over columns 1..M (a
# multiply and an add per column each) and the av chain (the count, three
# running means, two Kahan sums)
AV_COLUMN_FLOPS = 6
AV_STEP_FLOPS = 22
# per point once, at its loop exit in the per-omega kernel: four weighted
# sums over the columns
CAPTURE_COLUMN_FLOPS = 8
# per point and step of the per-omega chains: four angle additions
CHAIN_FLOPS = 12
# The kernels round each add and multiply on its own (-fmad=false, the
# plain version's rounding; with FMA contraction the f32 step kernel left
# the f32 envelope at BASELINE #4, PERF.md §6).  The H100's f32 rate
# outside the tensor cores, 67 TFLOP/s, counts an FMA as two operations;
# one add or multiply per lane and cycle is half of it.  HBM bandwidth:
# 3.35 TB/s.  Both from NVIDIA's data sheet (SXM part at 700 W).  Phase
# 19 measures the rate P1's chain sustains for a separate multiply and add;
# the bounds line prints the shares at that rate beside the data sheet's.
F32_OPS_PEAK = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12


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


def check_kernel_vs_plain(shape, dtype, n_steps=500, form=None):
    """Run the kernel (in `form`, as make_cuda_runner takes it: None is
    resident_plan's) and its plain version from one state over the same
    exact xs table, in two chunks (the first odd, so the second starts at
    parity 1), with display-77 records in both; raise on disagreement:
    the state and edges bit for bit, av and the records at TOL.  Returns
    (the largest abs difference of av and the records, the runner)."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    dev = torch.device(DEVICE)
    model, c, xs = _setup(shape, dtype, dev)
    n1 = n_steps // 2 + 1
    n2 = n_steps - n1
    parts = [({k: v[:n1] for k, v in xs.items()}, (0, 3, n1 // 2, n1 - 1)),
             ({k: v[n1:n_steps] for k, v in xs.items()},
              (1, n2 // 2, n2 - 1))]
    runner = stepper_cuda.make_cuda_runner(c, model, form=form)
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = f"B1 {runner.form} {dtype} {shape}"
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
        want = (stepper_cuda.LAUNCHES_PER_CHUNK if runner.form == "resident"
                else stepper_cuda.LAUNCHES_PER_STEP * n + len(emit))
        check(runner.launches - launches0 == want,
              f"{what}: {runner.launches - launches0} launches for {n} "
              f"steps (expected {want})")
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            k, p = getattr(kern, f), getattr(plain, f)
            check(torch.equal(k, p), f"{what} {f} not bit for bit, max abs "
                  f"err {float((k - p).abs().max()):.3e}")
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        check(int(kern.step) == int(plain.step) == steps, "step count")
        check(float(kern.t) == float(plain.t), "loop t")
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        check(torch.equal(obs[:, 4], ref[:, 4]), f"{what}: record loop t")
        err = max(err, allclose(obs, ref, what=f"{what} d77 records",
                                **tol))
    check(runner.launches > 0, "kernel never launched")
    return err, runner


def check_resident_vs_per_half_step(shape, dtype="f32", n_steps=203):
    """B1's two forms from one state over the same n_steps with display-77
    records: state and edges bit for bit (the same per-cell arithmetic,
    -fmad=false), av and records at TOL (the sums' order).  Returns the
    largest abs difference of av and the records."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    model, c, xs = _setup(shape, dtype, torch.device(DEVICE))
    res = stepper_cuda.make_cuda_runner(c, model, form="resident")
    per = stepper_cuda.make_cuda_runner(c, model, form="per-half-step")
    part = {k: v[:n_steps] for k, v in xs.items()}
    emit = (0, 57, 130, n_steps - 1)
    state0 = stencil.bootstrap_state(c, model)
    s1 = res.run_xs(state0.clone(), part, 0, emit_idx=emit)
    s2 = per.run_xs(state0.clone(), part, 0, emit_idx=emit)
    torch.cuda.synchronize()
    what = f"B1 resident vs per-half-step {dtype} {shape}"
    check(res.launches == stepper_cuda.LAUNCHES_PER_CHUNK,
          f"{what}: {res.launches} resident launches")
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        check(torch.equal(getattr(s1, f), getattr(s2, f)),
              f"{what}: {f} not bit for bit")
    check(bool(s1.av[0] > 0), f"{what}: av never fired")
    err = allclose(s1.av, s2.av, what=f"{what} av", **TOL[dtype])
    return max(err, allclose(torch.from_numpy(res.take_obs(len(emit))),
                             torch.from_numpy(per.take_obs(len(emit))),
                             what=f"{what} d77 records", **TOL[dtype]))


def time_per_step(fn, n_steps, reps=1, warm=True):
    """ms per step of fn() (which runs n_steps), by CUDA events, after one
    warm-up call when `warm`."""
    import torch
    if warm:
        fn()
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
    """Per-step device time of the kernel (in the form its plan picks) at
    one shape, and its cost per extra chunk (host sync + table copy),
    measured as 2000 steps in one chunk vs in 20 chunks."""
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


def _stream_runner(shape, dtype, forced=None, **kw):
    """(model, consts, xs, B2 runner) at one shape; kw go to
    make_stream_runner (form, K, W).  forced = (bands, R): a forced spill
    plan."""
    import torch
    from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
    model, c, xs = _setup(shape, dtype, torch.device(DEVICE))
    if forced is not None:
        kw["spill"] = sst.spill_plan(model.NHP, model.MP, model.np_dtype,
                                     sms=forced[0], R=forced[1])
        check(kw["spill"] is not None, f"no spill plan {forced} at {shape}")
    return model, c, xs, sst.make_stream_runner(c, model, **kw)


def check_stream_vs_plain(shape, dtype):
    """Run the stream kernel and its plain version from one state over
    the same table rows (from step 45, across the averaging window's start
    at step 50) in two chunks of odd length, K+3 steps (a full launch and
    a partial one) then 5 from parity 1, with display-77 records in both;
    raise on disagreement.  State and edges bit for bit; av and records
    at TOL (the block sums' order).  Returns the largest abs difference of
    av and the records."""
    import torch
    from slb2d_tpu_torch.ops import (stencil, stepper_cuda,
                                     stepper_stream_cuda as ssc)
    model, c, xs, runner = _stream_runner(shape, dtype)
    K = runner.geom.K
    rows = {k: v[45:45 + K + 8] for k, v in xs.items()}
    parts = [({k: v[:K + 3] for k, v in rows.items()}, (0, 4, K + 2)),
             ({k: v[K + 3:] for k, v in rows.items()}, (0, 2, 4))]
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = f"stream {dtype} {shape} {tuple(runner.geom)}"
    err = 0.0
    steps = 0
    for xs_part, emit in parts:
        n = len(xs_part["t"])
        launches0 = runner.launches
        kern = runner.run_xs(kern, xs_part, steps % 2, emit_idx=emit)
        table = stepper_cuda.pack_xs_dict(xs_part, model.np_dtype)
        plain, plain_obs = ssc.run_chunk_plain_stream(
            c, plain, table, steps % 2, emit, runner.geom)
        torch.cuda.synchronize()
        steps += n
        want = ssc.LAUNCHES_PER_LAUNCH * -(-n // K)
        check(runner.launches - launches0 == want,
              f"{what}: {runner.launches - launches0} launches for {n} "
              f"steps (expected {want})")
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            k, p = getattr(kern, f), getattr(plain, f)
            check(torch.equal(k, p), f"{what} {f} not bit for bit, max abs "
                  f"err {float((k - p).abs().max()):.3e}")
        check(bool(kern.av[0] > 0), f"{what}: av never fired")
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        check(int(kern.step) == int(plain.step) == steps, "step count")
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        check(torch.equal(obs[:, 4], ref[:, 4]), f"{what}: record loop t")
        err = max(err, allclose(obs, ref, what=f"{what} d77 records",
                                **tol))
    return err


def check_stream_vs_b1(shape, dtype="f32", n_steps=203):
    """B2 and B1 from one state over the same n_steps (odd: full launches
    and a partial one) with display-77 records: state and edges bit for
    bit (the same per-cell arithmetic, -fmad=false), av and records at
    TOL (the sums' order).  Returns the largest abs difference of av."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    model, c, xs, runner = _stream_runner(shape, dtype)
    b1 = stepper_cuda.make_cuda_runner(c, model)
    part = {k: v[:n_steps] for k, v in xs.items()}
    emit = (0, 57, 130, n_steps - 1)
    state0 = stencil.bootstrap_state(c, model)
    s2 = runner.run_xs(state0.clone(), part, 0, emit_idx=emit)
    s1 = b1.run_xs(state0.clone(), part, 0, emit_idx=emit)
    torch.cuda.synchronize()
    what = f"stream vs B1 {dtype} {shape}"
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        check(torch.equal(getattr(s2, f), getattr(s1, f)),
              f"{what}: {f} not bit for bit")
    check(bool(s1.av[0] > 0), f"{what}: av never fired")
    err = allclose(s2.av, s1.av, what=f"{what} av", **TOL[dtype])
    allclose(torch.from_numpy(runner.take_obs(len(emit))),
             torch.from_numpy(b1.take_obs(len(emit))),
             what=f"{what} d77 records", **TOL[dtype])
    return err


def check_spill_vs_plain(shape, dtype, n_steps=200, forced=None):
    """B2's spill form (its plan, or forced = (bands, R)) and its plain
    version (B1's, run_chunk_plain) from one state over the same table, in
    two chunks (the first odd, so the second starts at parity 1: a full
    chunk and a partial one), with display-77 records in both; raise on
    disagreement: the state and edges bit for bit, av and the records at
    TOL (the bands' sum order).  One launch a chunk.  Returns (the largest
    abs difference of av and the records, the runner)."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    model, c, xs, runner = _stream_runner(shape, dtype, forced=forced,
                                          form="spill")
    n1 = n_steps // 2 + 1
    n2 = n_steps - n1
    parts = [({k: v[:n1] for k, v in xs.items()}, (0, 3, n1 // 2, n1 - 1)),
             ({k: v[n1:n_steps] for k, v in xs.items()},
              (1, n2 // 2, n2 - 1))]
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    p = runner.plan
    what = (f"B2 spill {dtype} {shape} ({p.bands} bands, R={p.R}, "
            f"S={p.S})")
    err = 0.0
    steps = 0
    for xs_part, emit in parts:
        launches0 = runner.launches
        kern = runner.run_xs(kern, xs_part, steps % 2, emit_idx=emit)
        table = stepper_cuda.pack_xs_dict(xs_part, model.np_dtype)
        plain, plain_obs = stepper_cuda.run_chunk_plain(
            c, plain, table, steps % 2, emit)
        torch.cuda.synchronize()
        steps += len(xs_part["t"])
        check(runner.launches - launches0 == 1,
              f"{what}: {runner.launches - launches0} launches a chunk")
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            k, q = getattr(kern, f), getattr(plain, f)
            check(torch.equal(k, q), f"{what} {f} not bit for bit, max abs "
                  f"err {float((k - q).abs().max()):.3e}")
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        check(int(kern.step) == int(plain.step) == steps, "step count")
        check(float(kern.t) == float(plain.t), "loop t")
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        check(torch.equal(obs[:, 4], ref[:, 4]), f"{what}: record loop t")
        err = max(err, allclose(obs, ref, what=f"{what} d77 records",
                                **tol))
    check(bool(kern.av[0] > 0), f"{what}: av never fired")
    return err, runner


def check_stream_forms(shape, dtype="f32", n_steps=203):
    """B2's spill and tiling forms and B1's per-half-step form from one
    state over the same n_steps with display-77 records: state and edges
    bit for bit, av and records at TOL.  Returns the largest abs
    difference of av and the records."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    model, c, xs, spill = _stream_runner(shape, dtype, form="spill")
    tiling = _stream_runner(shape, dtype, form="tiling")[3]
    per = stepper_cuda.make_cuda_runner(c, model, form="per-half-step")
    part = {k: v[:n_steps] for k, v in xs.items()}
    emit = (0, 57, 130, n_steps - 1)
    state0 = stencil.bootstrap_state(c, model)
    out = {name: r.run_xs(state0.clone(), part, 0, emit_idx=emit)
           for name, r in (("spill", spill), ("tiling", tiling),
                           ("per-half-step", per))}
    torch.cuda.synchronize()
    what = f"B2 spill vs tiling vs B1 per-half-step {dtype} {shape}"
    err = 0.0
    for other, r in (("tiling", tiling), ("per-half-step", per)):
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            check(torch.equal(getattr(out["spill"], f),
                              getattr(out[other], f)),
                  f"{what}: {f} of spill and {other} not bit for bit")
        err = max(err, allclose(out["spill"].av, out[other].av,
                                what=f"{what} av vs {other}", **TOL[dtype]))
        err = max(err, allclose(
            torch.from_numpy(spill.take_obs(len(emit))),
            torch.from_numpy(r.take_obs(len(emit))),
            what=f"{what} d77 records vs {other}", **TOL[dtype]))
    check(bool(out["spill"].av[0] > 0), f"{what}: av never fired")
    return err


@contextlib.contextmanager
def forced_spill(bands):
    """Within it, B2's runners take a spill plan of `bands` bands at any
    shape (B1's resident plan or not), with the widest R that leaves each
    band two spill columns: the spill form at the goldens' small shapes."""
    from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
    plan = sst.spill_plan

    def forced(NHP, MP, dtype, sms=None, **kw):
        return plan(NHP, MP, dtype, sms=bands,
                    R=min((MP // bands - 2) // 32 * 32, 512))
    sst.spill_plan = forced
    try:
        yield
    finally:
        sst.spill_plan = plan


def engine_ms(shape, engine, dtype="f32", n=2000, reps=3, form=None,
              **kw):
    """ms per step of one kernel engine ('cuda-b1', in `form` as
    make_cuda_runner takes it, or 'stream', in `form` as
    make_stream_runner takes it, with _stream_runner's kw) at one shape: n
    steps in one chunk, CUDA events, after a warm-up."""
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    if engine == "stream":
        model, c, xs, runner = _stream_runner(shape, dtype, form=form, **kw)
        check(form is None or runner.form == form,
              f"stream {shape}: the {runner.form} form, not {form}")
    else:
        import torch
        model, c, xs = _setup(shape, dtype, torch.device(DEVICE))
        runner = stepper_cuda.make_cuda_runner(c, model, form=form)
    win = {k: v[:n] for k, v in xs.items()}
    st = stencil.bootstrap_state(c, model)
    return time_per_step(lambda: runner.run_xs(st, win, 0), n, reps=reps)


def sweep_grid(shape):
    """(config keywords, params) of one sweep check shape."""
    import numpy as np
    if shape == "ragged":
        params = {"E_dc": np.linspace(0.3, 2.0, 6),
                  **{k: np.asarray(v) for k, v in RAGGED_PARAMS.items()}}
        return {**PHYS, **SWEEP_RAGGED}, params
    if shape in ("ragged40", "omega_ragged40"):
        kw, params = sweep_grid(shape[:-2])
        return {**kw, **GRID40}, params
    if shape == "omega_ragged":
        return ({**PHYS, **OMEGA_RAGGED},
                {k: np.asarray(v) for k, v in OMEGA_RAGGED_PARAMS.items()})
    if shape in ("omega16x4", "paper"):
        e_dc = np.linspace(0.0, 3.0, 4 if shape == "omega16x4" else 16)
        E, W = np.meshgrid(e_dc, np.linspace(6.0, 14.0, 16), indexing="ij")
        return ({**MAP, "t_start": 0.05 if shape == "omega16x4" else 5.0},
                {"E_dc": E.ravel(), "omega": W.ravel()})
    if shape == "lanes3":
        return LANES3, {k: np.asarray(v) for k, v in LANES3_PARAMS.items()}
    if shape == "omega64":
        return ({**PHYS, **SWEEP_FULL},
                {"omega": np.linspace(0.8, 1.2, SWEEP_POINTS)})
    if shape == "wide8":
        return {**PHYS, **WIDE8}, {"E_dc": np.linspace(0.5, 2.0, 8)}
    if shape == "omega_wide8":
        return ({**PHYS, **OMEGA_WIDE8},
                {"omega": np.linspace(20.0, 30.0, 8)})
    return ({**PHYS, **SWEEP_FULL},
            {"E_dc": np.linspace(0.1, 3.0, SWEEP_POINTS)})


def _sweep_setup(shape, dtype, impl="cuda", cluster_size=None):
    """(sweep, its B3 runner) at one sweep check shape; cluster_size as
    SweepStackRunner takes it (None: cluster_plan's form, 0: the
    streaming form)."""
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.ops import sweep_stack_cuda
    from slb2d_tpu_torch.parallel.sweep import ParameterSweep
    kw, params = sweep_grid(shape)
    cfg = SimConfig(display=4, dtype=dtype, impl=impl, quiet=True, **kw)
    sweep = ParameterSweep(cfg, params, device=torch.device(DEVICE))
    if impl == "torch":
        return sweep, None
    check(sweep.engine == "cuda", f"sweep engine {sweep.engine}, not cuda")
    return sweep, sweep_stack_cuda.SweepStackRunner(
        sweep, cluster_size=cluster_size)


def form_name(runner):
    """'cluster CS=2' or 'streaming': the B3 form a runner launches."""
    return (f"cluster CS={runner.cluster_size}" if runner.form == "cluster"
            else "streaming")


def check_sweep_kernel_vs_plain(shape, dtype, n_steps=300,
                                cluster_size=None):
    """Run the sweep kernel (in the form cluster_size picks, as
    _sweep_setup takes it) and its plain version from one batched state
    over the same exact tables, in two chunks (the first odd, so the
    second starts at parity 1); raise on disagreement: the state arrays
    and edges bit for bit, av at TOL.  Returns (the largest abs difference
    of av, the runner)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    sweep, runner = _sweep_setup(shape, dtype, cluster_size=cluster_size)
    state0 = sweep._initial_states()
    kern, plain = state0.clone(), state0.clone()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = f"sweep {dtype} {shape} B={sweep.B} {form_name(runner)}"
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
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            k, p = getattr(kern, f), getattr(plain, f)
            allclose(k, p, what=f"{what} {f}", **tol)
            check(torch.equal(k, p), f"{what} {f} not bit for bit")
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        for st, name in ((kern, "kernel"), (plain, "plain")):
            check(bool(torch.all(st.av[dc_only] == 0)),
                  f"{what}: the dc-only point's av is not 0 ({name})")
        check(torch.equal(kern.step, plain.step), f"{what}: step count")
        check(torch.equal(kern.t, plain.t), f"{what}: loop t")
    if shape in ("ragged", "ragged40"):
        check(bool(dc_only.any()), "the ragged grid has no dc-only point")
    return err, runner


def in_turns(cluster_fn, streaming_fn, n_steps):
    """ms per step of the cluster and the streaming form, each timed
    twice by CUDA events in turns (cluster, streaming, streaming,
    cluster) after one warm-up call each: ([cluster ms], [streaming
    ms])."""
    out = {cluster_fn: [], streaming_fn: []}
    for fn in (cluster_fn, streaming_fn):
        fn()
    for fn in (cluster_fn, streaming_fn, streaming_fn, cluster_fn):
        out[fn].append(time_per_step(fn, n_steps, warm=False))
    return out[cluster_fn], out[streaming_fn]


def sweep_kernel_ms(n_kernel=1000, n_plain=30, n_engine=300):
    """ms per step of the sweep kernel in its cluster and its streaming
    form (CUDA events, one launch for n_kernel steps, in turns), of its
    plain version and of the batched torch engine (host clock to a
    synchronise), at the 64-point shape in f32: (cluster [ms], streaming
    [ms], plain, engine, the sweep)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    from slb2d_tpu_torch.parallel import sweep as swmod
    sweep, runner = _sweep_setup("full", "f32")
    check(runner.form == "cluster", f"the 64-point sweep's form is "
          f"{runner.form}")
    streaming = ssc.SweepStackRunner(sweep, cluster_size=0)
    st = sweep._initial_states()
    xs = runner.chunk_table(n_plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssc.run_chunk_plain(sweep.consts, st.clone(), xs, 0, runner.egate)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    k_ms, s_ms = in_turns(lambda: runner.advance(st, n_kernel),
                          lambda: streaming.advance(st, n_kernel), n_kernel)
    cap = _zero_cap(sweep)
    weights = sweep._weights()
    eng = sweep._initial_states()
    swmod._run_sweep(sweep.consts, eng, cap, weights, 2)    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swmod._run_sweep(sweep.consts, eng, cap, weights, n_engine)
    torch.cuda.synchronize()
    e_ms = (time.perf_counter() - t0) * 1e3 / n_engine
    return k_ms, s_ms, p_ms, e_ms, sweep


def sweep_main_phase(card):
    """The sweep CLI on the 64-point sweep, on B3's cluster form; returns
    (kernel launches, wall seconds, steps per point)."""
    import numpy as np
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    (_, wall, text, sweep, _, (omega_launches, launches, step_launches,
                               cluster, streaming)) = \
        _run_cli_keeping_results(SWEEP_ARGV)
    steps = sweep.n_steps
    runner = sweep._stack_runner
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
    check(omega_launches == 0,
          "the shared-omega sweep launched the per-omega kernel")
    check(runner.form == "cluster" and (cluster, streaming) == (want, 0),
          f"the sweep ran on the {runner.form} form; (cluster, streaming) "
          f"launches {(cluster, streaming)}, expected {(want, 0)}")
    sites = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * steps * sweep.B
    print(f"sweep main: sweep_cli {SWEEP_POINTS}-point E_dc sweep N=40 "
          f"M=500 f32 impl=cuda: {form_name(runner)}, {steps} steps, "
          f"{launches} launch(es) (cluster {cluster}, streaming "
          f"{streaming}), max |norm-1| {norm_err:.3e}, wall {wall:.3f} s, "
          f"{sites / wall:.4e} site-updates/s [{card}]", flush=True)
    return launches, wall, steps


def _zero_cap(sweep, frames=False):
    """A fresh loop-exit capture dict of a sweep, with the frames arrays
    "a", "b" when `frames`."""
    import torch
    from slb2d_tpu_torch.ops.stencil import CAP_KEYS
    dt, dev = sweep.consts.a0.dtype, sweep.device
    cap = {k: torch.zeros(sweep.B, dtype=dt, device=dev) for k in CAP_KEYS}
    if frames:
        shape = (sweep.B, sweep.base.NHP, sweep.base.MP)
        cap["a"] = torch.zeros(shape, dtype=dt, device=dev)
        cap["b"] = torch.zeros(shape, dtype=dt, device=dev)
    return cap


def check_omega_kernel_vs_plain(shape, dtype, n_steps=None, start=0,
                                cluster_size=None):
    """Run the per-omega sweep kernel (in the form cluster_size picks, as
    _sweep_setup takes it) and its plain version from one batched state
    over the same tables, in two chunks (151 steps, so the second starts
    at parity 1; both cross resync steps), with the frames capture on;
    raise on disagreement: the state arrays, edges and frames bit for bit,
    av and the capture sums at TOL.  The state is first advanced `start`
    steps by the kernel.  n_steps=None runs to the sweep's end, past every
    point's loop exit.  Returns (largest abs difference of av, of the four
    capture sums, points whose capture fired, the runner)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    from slb2d_tpu_torch.ops.stencil import CAP_KEYS
    sweep, runner = _sweep_setup(shape, dtype, cluster_size=cluster_size)
    check(runner.per_omega, f"{shape}: the runner is not in per-omega mode")
    n_steps = n_steps or sweep.n_steps - start
    state0, cap0 = sweep._initial_states(), _zero_cap(sweep, frames=True)
    if start:
        state0, cap0 = runner.advance(state0, start, cap=cap0)
    kern, plain = state0.clone(), state0.clone()
    kcap = {k: v.clone() for k, v in cap0.items()}
    pcap = {k: v.clone() for k, v in cap0.items()}
    fired0 = cap0["norm"] != 0
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = (f"omega {dtype} {shape} B={sweep.B} from step {start} "
            f"{form_name(runner)}")
    dc_only = ~runner.egate
    err = cap_err = 0.0
    for n in (151, n_steps - 151):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        launches0 = runner.launches
        kern, kcap = runner.advance(kern, n, cap=kcap)
        plain, pcap = ssc.run_chunk_plain_omega(
            sweep.consts, plain, pcap, xs, parity0, runner.egate, runner.pp,
            runner.w_d4, runner.w_d4_phi)
        torch.cuda.synchronize()
        want = -(-n // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK
        check(runner.launches - launches0 == want,
              f"{what}: {runner.launches - launches0} launches for {n} "
              f"steps (expected {want})")
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            k, p = getattr(kern, f), getattr(plain, f)
            allclose(k, p, what=f"{what} {f}", **tol)
            check(torch.equal(k, p), f"{what} {f} not bit for bit")
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        for k in CAP_KEYS:
            cap_err = max(cap_err, allclose(kcap[k], pcap[k],
                                            what=f"{what} capture {k}",
                                            **tol))
        for k in ("a", "b"):
            allclose(kcap[k], pcap[k], what=f"{what} frames {k}", **tol)
            check(torch.equal(kcap[k], pcap[k]),
                  f"{what} frames {k} not bit for bit")
        for st, name in ((kern, "kernel"), (plain, "plain")):
            check(bool(torch.all(st.av[dc_only] == 0)),
                  f"{what}: the dc-only point's av is not 0 ({name})")
        check(torch.equal(kern.step, plain.step), f"{what}: step count")
        check(torch.equal(kern.t, plain.t), f"{what}: loop t")
    fired = (kcap["norm"] != 0) & ~fired0
    check(bool(torch.equal(fired, (pcap["norm"] != 0) & ~fired0)),
          f"{what}: kernel and plain version captured different points")
    check(bool(fired.any()), f"{what}: no loop-exit capture fired")
    check(bool(torch.all(kern.av[~dc_only, 0] > 0)),
          f"{what}: a point never averaged")
    if start + n_steps == sweep.n_steps:
        # run to the end: every point's capture fired (norm ~1, not 0)
        check(bool(torch.all(kcap["norm"] != 0)),
              f"{what}: a point's loop-exit capture never fired")
    if shape in ("omega_ragged", "omega_ragged40"):
        check(bool(dc_only.any()), "the omega grid has no dc-only point")
    return err, cap_err, int(fired.sum()), runner


def batched_engine_ms(shape, n_steps=300):
    """ms per step of the batched torch engine on the card (host clock to
    a synchronise) at one sweep shape, f32."""
    import torch
    from slb2d_tpu_torch.parallel import sweep as swmod
    sweep, _ = _sweep_setup(shape, "f32", impl="torch")
    weights = sweep._weights()
    st, cap = sweep._initial_states(), _zero_cap(sweep)
    st, cap = swmod._run_sweep(sweep.consts, st, cap, weights, 2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swmod._run_sweep(sweep.consts, st, cap, weights, n_steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps, sweep


def omega_kernel_ms(shape, n_kernel=None, n_plain=30):
    """ms per step of the per-omega sweep kernel in its cluster and its
    streaming form (CUDA events, the first n_kernel steps of the sweep, by
    default all of them, in one launch per chunk as the main path runs
    them, the forms in turns) and of its plain version (host clock,
    n_plain steps from step 0), f32: (cluster [ms], streaming [ms],
    plain, the sweep)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    sweep, runner = _sweep_setup(shape, "f32")
    check(runner.form == "cluster", f"{shape}'s form is {runner.form}")
    streaming = ssc.SweepStackRunner(sweep, cluster_size=0)
    n_kernel = n_kernel or sweep.n_steps
    st = sweep._initial_states()
    xs = runner.chunk_table(n_plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssc.run_chunk_plain_omega(sweep.consts, st.clone(), _zero_cap(sweep),
                              xs, 0, runner.egate, runner.pp, runner.w_d4,
                              runner.w_d4_phi)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain

    def kernel(r):
        r.seek(0)                   # the same steps, windows and exits
        r.advance(st.clone(), n_kernel, cap=_zero_cap(sweep))

    k_ms, s_ms = in_turns(lambda: kernel(runner), lambda: kernel(streaming),
                          n_kernel)
    return k_ms, s_ms, p_ms, sweep


def omega_sweep_phase(card):
    """The 16 x 4 omega grid through the per-omega kernel against the
    batched torch engine, both on the card; returns the largest relative
    difference of the observables."""
    import numpy as np
    kern, _ = _sweep_setup("omega16x4", "f32")
    batched, _ = _sweep_setup("omega16x4", "f32", impl="torch")
    res_k, res_b = kern.run(), batched.run()
    check(np.array_equal(res_k["av_count"], res_b["av_count"]),
          "omega sweep av_count: kernel path and batched engine differ")
    check(len(np.unique(res_k["av_count"])) > 8,
          "the omega sweep's windows do not differ per point")
    worst = 0.0
    for k in OBS:
        got, ref = np.asarray(res_k[k], float), np.asarray(res_b[k], float)
        err = np.abs(got - ref)
        check(bool(np.all(err <= 2e-5 + 2e-4 * np.abs(ref))),
              f"omega sweep {k}: outside 2e-4 rel / 2e-5 abs, max abs err "
              f"{err.max():.3e}")
        worst = max(worst, float(err.max()))
    print(f"omega sweep: 16 x 4 grid N=40 M=500 f32, {kern.n_steps} steps, "
          f"per-omega kernel vs batched torch engine: av_count exact, max "
          f"abs err {worst:.3e} (2e-4 rel / 2e-5 abs) [{card}]", flush=True)
    return worst


def expected_av_counts(sweep):
    """Each point's averaging-step count from the host schedule alone: the
    loop t of every step by sequential accumulation in the sweep's dtype,
    inside [t_start, t_start + T_p), for points with E_omega > 0."""
    import numpy as np
    from slb2d_tpu_torch.runtime.schedule import accum_sequence
    D = sweep.base.np_dtype
    ts = accum_sequence(0.0, sweep.base.dt, sweep.n_steps - 1, D)
    t0 = D(sweep.cfg.t_start)
    return np.array([np.count_nonzero((ts >= t0) & (ts < D(t0 + m.T)))
                     if float(m.E_omega) > 0 else 0 for m in sweep.models],
                    float)


def _run_cli_keeping_results(argv):
    """sweep_cli.main(argv) with the launch counts zeroed just before and
    read just after; returns (rc, wall, table text, the ParameterSweep,
    its results, (per-omega, shared, step kernel launches, B3 launches on
    the cluster form, on the streaming form))."""
    import torch
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.ops import stepper_cuda, sweep_stack_cuda as ssc
    from slb2d_tpu_torch.parallel import sweep as swmod
    seen = []
    finalize = swmod.ParameterSweep._finalize

    def keep(self, final, cap):
        res = finalize(self, final, cap)
        seen.append((self, res))
        return res

    swmod.ParameterSweep._finalize = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sweep.txt")
            torch.cuda.synchronize()
            stepper_cuda.launch_count = 0
            ssc.launch_count = ssc.omega_launch_count = 0
            ssc.cluster_launch_count = ssc.streaming_launch_count = 0
            t0 = time.perf_counter()
            rc = sweep_cli.main(argv + [f"o={path}"])
            wall = time.perf_counter() - t0  # ends in the result fetch
            counts = (ssc.omega_launch_count, ssc.launch_count,
                      stepper_cuda.launch_count, ssc.cluster_launch_count,
                      ssc.streaming_launch_count)
            with open(path) as fh:
                text = fh.read()
    finally:
        swmod.ParameterSweep._finalize = finalize
    check(rc == 0 and len(seen) == 1, f"sweep_cli.main returned {rc}")
    return rc, wall, text, seen[0][0], seen[0][1], counts


def omega_main_phase(card):
    """The sweep CLI on the 16 x 16 paper map through the per-omega
    kernel; returns (kernel launches, wall seconds, steps, sweep)."""
    import numpy as np
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    (_, wall, text, sweep, res, (launches, shared, step, cluster,
                                 streaming)) = \
        _run_cli_keeping_results(PAPER_ARGV)
    steps = sweep.n_steps
    runner = sweep._stack_runner
    check(sweep.engine == "cuda", f"paper map on the {sweep.engine} engine")
    lines = text.splitlines()
    check(lines[0] + "\n" == sweep_cli.HEADER, f"header {lines[0]!r}")
    rows = np.array([l.split() for l in lines[1:]], float)
    check(rows.shape == (PAPER_POINTS, 15),
          f"expected {PAPER_POINTS} 15-column lines, got {rows.shape}")
    check(bool(np.all(np.isfinite(rows))), "non-finite map output")
    E, W = np.meshgrid(np.linspace(0, 3, 16), np.linspace(6, 14, 16),
                       indexing="ij")
    check(np.allclose(rows[:, 0], E.ravel(), rtol=1e-11, atol=1e-15)
          and np.allclose(rows[:, 2], W.ravel(), rtol=1e-11, atol=0),
          "the E_dc and omega columns")
    norm_err = float(np.max(np.abs(rows[:, 14] - 1.0)))
    check(norm_err < 1e-3, f"a point's norm is {norm_err} from 1")
    want_counts = expected_av_counts(sweep)
    check(np.array_equal(res["av_count"], want_counts),
          f"av_count differs from the schedule at "
          f"{np.flatnonzero(res['av_count'] != want_counts)[:8].tolist()}")
    want = -(-steps // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK
    check(launches == want, f"{launches} per-omega kernel launches for "
          f"{steps} steps (expected {want})")
    check(shared == 0, "the omega map launched the shared-omega kernel")
    check(step == 0, "the omega map launched the step kernel")
    check(runner.form == "cluster" and (cluster, streaming) == (want, 0),
          f"the map ran on the {runner.form} form; (cluster, streaming) "
          f"launches {(cluster, streaming)}, expected {(want, 0)}")
    sites = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * steps * sweep.B
    print(f"omega main: sweep_cli 16x16 paper map N=40 M=500 f32 impl=cuda: "
          f"{form_name(runner)}, {steps} steps, {launches} launch(es) "
          f"(cluster {cluster}, streaming {streaming}), av_count = schedule for "
          f"all {sweep.B} points, max |norm-1| {norm_err:.3e}, wall "
          f"{wall:.3f} s, {sites / wall:.4e} site-updates/s [{card}]",
          flush=True)
    return launches, wall, steps, sweep


def omega_routing_phase(card, paper_wall, paper_steps):
    """Why impl=auto routes omega sweeps to the kernel: the kernel
    path's end-to-end wall against the batched engine's time per step
    times the steps (a lower bound of its wall), at bench.py's 64-point
    omega sweep and at the paper map."""
    rows = []
    _, wall64, _, sw64, _, (n64, *_) = \
        _run_cli_keeping_results(OMEGA64_ARGV)
    check(sw64.engine == "cuda" and n64 >= 1,
          "the 64-point omega sweep did not launch the per-omega kernel")
    for name, wall, steps, shape in (
            ("64-point omega sweep", wall64, sw64.n_steps, "omega64"),
            ("16x16 paper map", paper_wall, paper_steps, "paper")):
        e_ms, sweep = batched_engine_ms(shape)
        est = e_ms * steps / 1e3
        rows.append(wall < est)
        sites = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * sweep.B
        print(f"omega routing: {name} ({sweep.B} points, {steps} steps): "
              f"kernel path end to end {wall:.3f} s "
              f"({sites * steps / wall:.4e} site-updates/s); batched "
              f"engine {e_ms:.5f} ms/step x {steps} steps = {est:.3f} s "
              f"({sites / (e_ms * 1e-3):.4e} site-updates/s); kernel "
              f"{'faster' if wall < est else 'NOT faster'} [{card}]",
              flush=True)
    return all(rows)


def _check_frames(d, n_points, M):
    import numpy as np
    from slb2d_tpu_torch.ops.frames import phi_x_grid
    with open(os.path.join(d, "index.txt")) as fh:
        idx = fh.read().splitlines()
    check(len(idx) == n_points + 1 and idx[0].startswith("#point"),
          f"{d}: index.txt has {len(idx)} lines")
    X = len(phi_x_grid(np.float32))
    for i in range(n_points):
        with open(os.path.join(d, f"point{i:04d}.data")) as fh:
            lines = fh.read().splitlines()
        check(lines[0].startswith("# E_dc=") and
              lines[-1].startswith("# norm="), f"{d} point {i}: headers")
        body = np.array([l.split() for l in lines[1:-1]], float)
        check(body.shape == (X * (M + 1), 3), f"{d} point {i}: "
              f"{body.shape} triplets, expected {(X * (M + 1), 3)}")
        norm = float(lines[-1][len("# norm="):])
        check(bool(np.all(np.isfinite(body))) and abs(norm - 1) < 1e-3,
              f"{d} point {i}: non-finite frame or norm {norm}")


def _frame_values(d, n_points):
    import numpy as np
    out = []
    for i in range(n_points):
        with open(os.path.join(d, f"point{i:04d}.data")) as fh:
            out.append(np.array([l.split()[2] for l in fh
                                 if not l.startswith("#")], float))
    return out


def frames_phase(card):
    """sweep_cli frames-dir= on the card: a shared-omega grid through the
    kernel, an omega grid through the per-omega kernel (impl=cuda and
    impl=auto) and through the batched engine (impl=torch); the kernel's
    frames against the batched engine's at 2e-4 rel / 2e-5 of the frame's
    largest value."""
    import numpy as np
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    small = ["E_dc=1", "E_omega=2", "omega=10", "mu=1", "alpha=0.9495",
             "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10", "B=0.1",
             "t-max=0.3", "dt=1e-3", "g-grid=24", "quiet=1"]
    omega = ["sweep:omega=8;12", "sweep:E_dc=0.5;1.5"]
    # (shared, per-omega, cluster-form, streaming-form) launches
    runs = (("fa", "cuda", ["sweep:E_dc=0.5;1.5"], 2, (1, 0, 1, 0)),
            ("fc", "cuda", omega, 4, (0, 1, 1, 0)),
            ("fu", "auto", omega, 4, (0, 1, 1, 0)),
            ("fb", "torch", omega, 4, (0, 0, 0, 0)))
    with tempfile.TemporaryDirectory() as tmp:
        for name, impl, grid, n, want in runs:
            ssc.launch_count = ssc.omega_launch_count = 0
            ssc.cluster_launch_count = ssc.streaming_launch_count = 0
            rc = sweep_cli.main(small + [f"impl={impl}", *grid,
                                         f"o={tmp}/{name}.txt",
                                         f"frames-dir={tmp}/{name}"])
            got = (ssc.launch_count, ssc.omega_launch_count,
                   ssc.cluster_launch_count, ssc.streaming_launch_count)
            check(rc == 0 and got == want,
                  f"frames run {name} (impl={impl}): rc {rc}, (shared, "
                  f"per-omega, cluster, streaming) kernel launches {got}, "
                  f"expected {want}")
            _check_frames(os.path.join(tmp, name, "grid00"), n, 24)
        ref = _frame_values(os.path.join(tmp, "fb", "grid00"), 4)
        worst = 0.0
        for name in ("fc", "fu"):
            d = os.path.join(tmp, name, "grid00")
            for i, (got, want) in enumerate(zip(_frame_values(d, 4), ref)):
                err = np.abs(got - want)
                check(bool(np.all(err <= 2e-4 * np.abs(want)
                                  + 2e-5 * np.abs(want).max())),
                      f"frames {name} point {i}: the kernel's frame differs "
                      f"from the batched engine's, max abs err {err.max()}")
                worst = max(worst, float(err.max() / np.abs(want).max()))
    print(f"frames: sweep_cli frames-dir= shared omega on the kernel (1 "
          f"launch), omega grid on the per-omega kernel (impl=cuda, "
          f"impl=auto; 1 launch each, cluster form) and on the batched engine "
          f"(impl=torch); files and norms ok; kernel vs batched engine "
          f"frames max abs err {worst:.3e} of the frame's largest value "
          f"[{card}]", flush=True)


def forms_phase(card):
    """What each form of B3 takes on the card, both modes, float and
    double, at N=40 M=500 (NHP=48, MP=512) and at the ragged grids'
    NHP=16 MP=128: registers and spill bytes a thread, shared memory a
    block and the clusters (streaming form: blocks) that run at once, for
    the streaming form and every cluster size that holds the point.
    Raises where a cluster the plan allows cannot run on the card.
    Returns {(shape, dtype, per_omega, cluster size): form_info}."""
    import numpy as np
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    out = {}
    for shape, NHP, MP in (("N=40 M=500", 48, 512), ("NHP=16 MP=128", 16,
                                                     128)):
        for dtype in ("f32", "f64"):
            D = np.float32 if dtype == "f32" else np.float64
            sizes = [cs for cs in ssc.CLUSTER_SIZES
                     if ssc.cluster_smem_bytes(NHP, MP, D, cs) is not None]
            for per_omega in (False, True):
                for cs in [0] + sizes:
                    info = ssc.form_info(D, per_omega, cs, NHP, MP)
                    check(info["active_clusters"] > 0,
                          f"B3 {shape} {dtype} cluster size {cs}: no "
                          f"cluster runs on the card")
                    out[shape, dtype, per_omega, cs] = info
    print("forms: B3 on the card, (shape, dtype, mode, cluster size (0: "
          "streaming)): registers, spill bytes, shared bytes a block, "
          "clusters at once: " + "; ".join(
              f"{sh} {d} {'per-omega' if po else 'shared'} {cs}: "
              f"{v['registers']}, {v['local_bytes']}, {v['smem_bytes']}, "
              f"{v['active_clusters']}"
              for (sh, d, po, cs), v in out.items()) + f" [{card}]",
          flush=True)
    return out


def check_cluster_vs_streaming(shape):
    """B3's cluster form (the plan's) against its streaming form over the
    whole sweep from one state, f32, one launch per chunk as the main path
    runs it: the state arrays and edges (per-omega mode: and the frames)
    bit for bit, av and the capture sums at TOL.  Returns (largest abs
    difference of av, of the capture sums, the cluster-form runner)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    from slb2d_tpu_torch.ops.stencil import CAP_KEYS
    sweep, clu = _sweep_setup(shape, "f32")
    check(clu.form == "cluster", f"{shape}: the {clu.form} form")
    stm = ssc.SweepStackRunner(sweep, cluster_size=0)
    state0 = sweep._initial_states()
    n, tol = sweep.n_steps, TOL["f32"]
    what = f"{shape} cluster form vs streaming form"
    if clu.per_omega:
        got, gcap = clu.advance(state0.clone(), n,
                                cap=_zero_cap(sweep, frames=True))
        ref, rcap = stm.advance(state0.clone(), n,
                                cap=_zero_cap(sweep, frames=True))
    else:
        got, ref = clu.advance(state0.clone(), n), stm.advance(
            state0.clone(), n)
        gcap = rcap = {}
    torch.cuda.synchronize()
    want = -(-n // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK
    check(clu.launches == stm.launches == want,
          f"{what}: launches {clu.launches}, {stm.launches} (expected "
          f"{want})")
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        check(torch.equal(getattr(got, f), getattr(ref, f)),
              f"{what}: {f} not bit for bit")
    err = allclose(got.av, ref.av, what=f"{what} av", **tol)
    cap_err = 0.0
    for k in CAP_KEYS if clu.per_omega else ():
        cap_err = max(cap_err, allclose(gcap[k], rcap[k],
                                        what=f"{what} capture {k}", **tol))
    for k in ("a", "b") if clu.per_omega else ():
        check(torch.equal(gcap[k], rcap[k]),
              f"{what}: frames {k} not bit for bit")
    return err, cap_err, clu


def b1_forms_phase(card):
    """What B1's resident form takes on the card at its plan for the
    three f32 shapes and BASELINE #4 in f64: registers and spill bytes a
    thread, dynamic and static shared memory and threads a block, blocks
    at once on the card (at least the plan's bands).  Returns {(shape
    name, dtype): (plan, form_info)}."""
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.ops import stepper_cuda
    out = {}
    for name, shape, dtype in (("BASELINE#4", BASELINE4, "f32"),
                               ("BASELINE#4", BASELINE4, "f64"),
                               ("N=100 M=12000", WIDE, "f32"),
                               ("N=400 M=4000", TALL, "f32")):
        m = SuperlatticeModel(SimConfig(display=4, dtype=dtype, t_start=10.0,
                                        **PHYS, **shape))
        plan = stepper_cuda.resident_plan(m.NHP, m.MP, m.np_dtype,
                                          stepper_cuda.card_sms(DEVICE))
        check(plan is not None, f"B1 {name} {dtype}: no resident plan")
        info = stepper_cuda.form_info(m.np_dtype, plan.W, m.NHP, m.MP)
        check(info["smem_bytes"] == plan.smem_bytes
              and info["threads"] == plan.threads
              and info["blocks_at_once"] >= plan.bands,
              f"B1 {name} {dtype}: {plan} against the card's {info}")
        out[name, dtype] = (plan, info)
    print("B1 forms: the resident form on the card, (shape, dtype): band "
          "W, bands, threads, registers, spill bytes, shared bytes "
          "(dynamic + static), blocks at once: " + "; ".join(
              f"{n} {d}: {p.W}, {p.bands}, {i['threads']}, "
              f"{i['registers']}, {i['local_bytes']}, {i['smem_bytes']} + "
              f"{i['static_smem_bytes']}, {i['blocks_at_once']}"
              for (n, d), (p, i) in out.items()) + f" [{card}]", flush=True)
    return out


# the resident form where the cells cost next to nothing: N=7 M=4000
# (NHP=8, MP=4096), 128 bands of 32 columns, 256 cells a block
BARRIER = dict(n_harmonics=7, g_grid=4000)


def barrier_phase(card):
    """µs per step of B1's resident form at BARRIER (the two grid barriers
    of a step with their halo exchange, the row sums and the step's
    table reads: the fixed cost of a resident step) and of its
    per-half-step form there (three launches a step), in turns, f32.
    Returns ([resident µs], [per-half-step µs])."""
    t = {"resident": [], "per-half-step": []}
    for form in ("resident", "per-half-step", "per-half-step", "resident"):
        t[form].append(engine_ms(BARRIER, "cuda-b1", form=form) * 1e3)
    print(f"barrier: B1 at N=7 M=4000 f32 (128 bands of 32 columns, 256 "
          f"cells a block), us per step in turns: resident "
          f"{', '.join(f'{v:.3f}' for v in t['resident'])}, per-half-step "
          f"{', '.join(f'{v:.3f}' for v in t['per-half-step'])} [{card}]",
          flush=True)
    return t["resident"], t["per-half-step"]


def _sass_ops(instrs):
    """All instructions but NOPs, and the loads, stores and FP32 ones."""
    import re
    ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
           for _, t in instrs]
    ops = [o for o in ops if o != "NOP"]
    keys = ("LDS", "STS", "LDG", "STG", "FADD", "FMUL", "FFMA", "MUFU")
    return {"all": len(ops), **{k: ops.count(k) for k in keys}}


def b1_sass(lib_path):
    """B1's cell code in SASS (cuobjdump -sass, the toolkit's beside
    nvcc), float: each half_step<float, MAIN> instance whole (one cell a
    thread: index arithmetic, masks, loads, the cell, the IEEE division's
    fast path and its slow-path subroutine) and to its first EXIT, and the
    resident kernel's cell loops in address order (its innermost loops
    that hold the division's MUFU, one cell a trip: the halo cells, then
    rows 0-1, rows 2..N-1 and rows >= N of each half-step; the division's
    slow path is a call out of the loop).  Returns {name: counts}."""
    import re
    from slb2d_tpu_torch.ops import _build
    from slb2d_tpu_torch.perf import vpu_roofline as vr
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for name, (instrs, labels) in vr.sass_listing(text).items():
        k = re.search(r"\dhalf_stepIfLb([01])E", name)
        if k:
            key = f"half_step<float,{'MAIN' if k.group(1) == '1' else 'HALF'}>"
            end = next((i for i, (_, t) in enumerate(instrs)
                        if re.match(r"EXIT\b", t)), len(instrs) - 1)
            out[key] = {**_sass_ops(instrs),
                        "to_first_exit": _sass_ops(instrs[:end + 1])["all"]}
            continue
        if not re.search(r"\dresident_chunkIfE", name):
            continue
        loops = vr.sass_loops(instrs, labels)
        inner = sorted((a, b) for a, b in loops
                       if not any(a <= c and d <= b and (c, d) != (a, b)
                                  for c, d in loops))
        bodies = [[i for i in instrs if a <= i[0] <= b] for a, b in inner]
        cells = [b for b in bodies if any(t.startswith("MUFU") or
                                          " MUFU" in t for _, t in b)]
        for j, body in enumerate(cells):
            out[f"resident_chunk<float> cell loop {j}"] = _sass_ops(body)
    check(len(out) >= 4, f"B1 SASS: found {sorted(out)}")
    print("B1 SASS (float; all instructions but NOPs, of them LDS, STS, "
          "LDG, STG, FADD, FMUL, FFMA, MUFU): " + "; ".join(
              f"{k}: {v['all']}"
              + (f" ({v['to_first_exit']} to the first EXIT)"
                 if "to_first_exit" in v else "")
              + " [" + " ".join(str(v[o]) for o in (
                  "LDS", "STS", "LDG", "STG", "FADD", "FMUL", "FFMA",
                  "MUFU")) + "]"
              for k, v in out.items()), flush=True)
    return out


def main_path_flops(m, steps, points=1, av_steps=0, captures=0,
                    chains=False):
    """Floating-point operations a main path's kernel work needs: `steps`
    steps of `points` points of model m, `av_steps` averaging steps
    summed over the points, `captures` in-kernel loop-exit captures, and
    the per-omega chains when `chains`."""
    cols = 2 * m.M + 1                   # main grid M+1, half grid M
    per_step = CELL_FLOPS * m.N * cols + COLUMN_FLOPS * cols + STEP_FLOPS
    if chains:
        per_step += CHAIN_FLOPS
    return (per_step * steps * points
            + (AV_COLUMN_FLOPS * m.M + AV_STEP_FLOPS) * av_steps
            + CAPTURE_COLUMN_FLOPS * m.M * captures)


def bound_of(ops, nbytes, units, ops_rate):
    """(ms per unit, 'operations' or 'bytes'): the larger of `ops` at
    ops_rate operations per second and `nbytes` at HBM_BYTES_PER_S,
    divided by `units` (steps, turns or passes)."""
    t_ops, t_bytes = ops / ops_rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3 / units,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_ms(m, steps, flops, points=1, a0_arrays=2, ops_rate=F32_OPS_PEAK):
    """(ms per step, 'operations' or 'bytes'): the least time the card
    could take for `steps` steps of a main path's kernel work, the larger
    of its `flops` at ops_rate (F32_OPS_PEAK, the data sheet's, by
    default) and its bytes at HBM_BYTES_PER_S (the
    state read once and written once, a0 and a0_ghost read once per
    point that has its own, the xs table read once), divided by the
    steps."""
    esize = m.np_dtype(0).itemsize
    cells = m.NHP * m.MP
    nbytes = esize * (2 * 4 * cells * points + a0_arrays * cells
                      + steps * 10)
    return bound_of(flops, nbytes, steps, ops_rate)


def window_steps(m, t_start, steps):
    """The averaging steps of a display-4 run of model m: loop t of every
    step by sequential accumulation in m's dtype, inside [t_start,
    t_start + T)."""
    import numpy as np
    from slb2d_tpu_torch.runtime.schedule import accum_sequence
    D = m.np_dtype
    ts = accum_sequence(0.0, m.dt, steps - 1, D)
    t0 = D(t_start)
    return int(np.count_nonzero((ts >= t0) & (ts < D(t0 + m.T))))


def ptxas_summary(log):
    """'kernel<type>: N registers[, spills]' for each compiled kernel."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(lanes_half_step|lanes_cluster|t_half_step|"
                          r"t_resident_chunk|half_step|av_step|"
                          r"record_step|resident_chunk|sweep_chunk|"
                          r"sweep_cluster|"
                          r"stream_tile|"
                          r"stream_replay|vpu_chain|roll_reg_warp|"
                          r"roll_reg_halo|roll_pass)"
                          r"((?:I(?:[fd]|Li\d+E|Lb[01])+)?)",
                          m.group(1))
            args = (re.findall(r"[fd](?=Li|Lb|E|$)|(?<=Li)\d+|(?<=Lb)[01]",
                               k.group(2).lstrip("I")) if k else [])
            name = (f"{k.group(1)}<{','.join(args)}>" if k
                    else m.group(1))
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


def golden_phase(card, impl="cuda", form=None):
    """Display 4 through `impl` against the reference's d4_base1_*.txt;
    form: the form the run must have taken ('spill' under forced_spill)."""
    import numpy as np
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.runtime.loop import Simulation
    for gold, dtype, rtol, atol in GOLDENS:
        with open(os.path.join(ROOT, "tests", "golden", gold)) as fh:
            gold_text = fh.read()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.txt")
            cfg = SimConfig(display=4, dtype=dtype, impl=impl, quiet=True,
                            t_start=10.0, n_harmonics=20, g_grid=200,
                            out_file=path, **PHYS)
            sim = Simulation(cfg, device=torch.device(DEVICE))
            sim.run()
            with open(path) as fh:
                mine = fh.read()
        check(form is None or sim.engine_tag().endswith(form),
              f"{gold} impl={impl}: ran on {sim.engine_tag()}, not {form}")

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
        print(f"golden {gold} impl={impl} ({sim.engine_tag()}): ok (max "
              f"abs err "
              f"{err.max():.3e}, rtol {rtol}, atol {atol}) [{card}]",
              flush=True)


def routed_engine(model):
    """The engine impl=cuda and impl=auto take for model's grid."""
    from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
    return ("stream" if sst.stream_beats_b1(model.NHP, model.MP,
                                            model.np_dtype) else "cuda-b1")


def planned_form(model):
    """The form B1's runner takes for model's grid on this card."""
    from slb2d_tpu_torch.ops import stepper_cuda
    plan = stepper_cuda.resident_plan(model.NHP, model.MP, model.np_dtype,
                                      stepper_cuda.card_sms(DEVICE))
    return "per-half-step" if plan is None else "resident"


def stream_form(model):
    """The form B2's runner takes for model's grid on this card."""
    from slb2d_tpu_torch.ops import stepper_cuda, stepper_stream_cuda as sst
    plan = sst.spill_plan(model.NHP, model.MP, model.np_dtype,
                          stepper_cuda.card_sms(DEVICE))
    return "tiling" if plan is None else "spill"


def expected_launches(engine, steps, records=0, form=None, chunks=1):
    """((B1, B2, B3 shared, B3 per-omega), (B1 resident, B1 per-half-step,
    B2 spill, B2 tiling)) launches of a single run of `chunks` chunks: B1
    resident and B2 spill one per chunk, B1 per-half-step three per step
    and one per display-77 record, B2 tiling two per K steps."""
    from slb2d_tpu_torch.ops import stepper_cuda, stepper_stream_cuda as sst
    if engine == "stream" and form == "spill":
        n = stepper_cuda.LAUNCHES_PER_CHUNK * chunks
        return (0, n, 0, 0), (0, 0, n, 0)
    if engine == "stream":
        n = sst.LAUNCHES_PER_LAUNCH * -(-steps // sst.DEFAULT_K)
        return (0, n, 0, 0), (0, 0, 0, n)
    if form == "resident":
        n = stepper_cuda.LAUNCHES_PER_CHUNK * chunks
        return (n, 0, 0, 0), (n, 0, 0, 0)
    n = stepper_cuda.LAUNCHES_PER_STEP * steps + records
    return (n, 0, 0, 0), (0, n, 0, 0)


def run_chunks(model, display, t_start=10.0):
    """(chunks, display-77 records) of a CLI run of model at `display`:
    the Simulation's schedule (runtime/loop.py CUDA_CHUNK_DEFAULT)."""
    from slb2d_tpu_torch.runtime import schedule
    from slb2d_tpu_torch.runtime.loop import CUDA_CHUNK_DEFAULT
    D = model.np_dtype
    chunks = list(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0,
        t_max=float(D(D(t_start) + model.T)), t_start=t_start,
        E_omega=model.E_omega, display=display, frame_start=0.0, T=model.T,
        dtype=D, chunk_max=CUDA_CHUNK_DEFAULT, break_on_e77=False))
    return len(chunks), sum(len(ch.emit_idx) for ch in chunks)


def run_steps(model, t_start=10.0):
    """Steps of a run of model from t=0 to t_start + T."""
    from slb2d_tpu_torch.runtime import schedule
    D = model.np_dtype
    return schedule.count_steps(0.0, float(D(D(t_start) + model.T)),
                                model.dt, D)


def main_path_phase(card):
    """The CLI at BASELINE #4 with impl=cuda, on the engine (and B1 form)
    the routing picks; returns (wall seconds, steps, engine)."""
    import numpy as np
    from slb2d_tpu_torch.config import parse_cmd
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel

    model = SuperlatticeModel(parse_cmd(MAIN_ARGV))
    steps = run_steps(model)
    engine = routed_engine(model)
    form = planned_form(model) if engine == "cuda-b1" else stream_form(model)
    wall, text, counts, forms = run_cli(MAIN_ARGV)
    rows = [l.split() for l in text.splitlines()
            if l and not l.startswith("#")]
    check(len(rows) == 1 and len(rows[0]) == 13,
          f"expected one 13-column line, got {rows}")
    vals = np.array(rows[0], float)
    check(bool(np.all(np.isfinite(vals))), f"non-finite output {vals}")
    check(abs(vals[6] - 1.0) < 1e-3, f"NORM {vals[6]} not within 1e-3 of 1")
    want = expected_launches(engine, steps, form=form,
                             chunks=run_chunks(model, 4)[0])
    check((counts, forms) == want,
          f"(B1, B2, B3, B3 per-omega), (B1 resident, B1 per-half-step, "
          f"B2 spill, B2 tiling) launches {(counts, forms)} for {steps} "
          f"steps on {engine} {form} (expected {want})")
    sites = 2 * (model.N + 1) * (model.M + 1) * steps
    print(f"main: cli display=4 BASELINE#4 f32 impl=cuda [{engine} {form}]: "
          f"{steps} steps, launches B1 "
          f"{counts[0]} (resident {forms[0]}, per-half-step {forms[1]}) B2 "
          f"{counts[1]} (spill {forms[2]}, tiling {forms[3]}), "
          f"NORM={vals[6]:.9f}, wall {wall:.3f} s, "
          f"{sites / wall:.4e} site-updates/s [{card}]", flush=True)
    return wall, steps, engine


def d77_golden_phase(card, impls=("cuda", "stream"), form=None):
    """Display 77 on each of `impls` against the patched reference's
    recorded lines (tests/test_golden.py:135-202): t bit for bit, all 15
    columns at f32 rtol 2e-4 atol 8e-6, f64 rtol 5e-9 atol 1e-12; form:
    the form the impl=stream runs must have taken."""
    import gzip
    import numpy as np
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.runtime.loop import Simulation
    done = []
    for gold, dtype, rtol, atol in D77_GOLDENS:
        with gzip.open(os.path.join(ROOT, "tests", "golden", gold),
                       "rt") as fh:
            ref = [np.array(l.split(), float) for l in fh.read().splitlines()
                   if l and not l.startswith("#")]
        for impl in impls:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "d77.txt")
                cfg = SimConfig(display=77, dtype=dtype, impl=impl,
                                quiet=True, t_start=0.2, n_harmonics=8,
                                g_grid=24, out_file=path,
                                **{**PHYS, "omega": 10.0})
                sim = Simulation(cfg, device=torch.device(DEVICE))
                sim.run()
                with open(path) as fh:
                    mine = [np.array(l.split(), float)
                            for l in fh.read().splitlines()
                            if l and not l.startswith("#")]
            what = f"{gold} impl={impl} ({sim.engine_tag()})"
            check(form is None or impl != "stream"
                  or sim.engine_tag() == f"stream {form}",
                  f"{what}: not on the {form} form")
            check(len(mine) == len(ref) > 50,
                  f"{what}: {len(mine)} lines, expected {len(ref)}")
            err = 0.0
            for g, m in zip(ref, mine):
                check(m[13] == g[13], f"{what}: t {m[13]} != {g[13]}")
                e = np.abs(m - g)
                check(bool(np.all(e <= atol + rtol * np.abs(g))),
                      f"{what}: columns outside rtol={rtol} atol={atol}, "
                      f"max abs err {e.max():.3e}")
                err = max(err, float(e.max()))
            done.append(f"{what} max abs err {err:.3e}")
    print(f"golden d77: {len(ref)} lines each, t bit for bit: "
          + "; ".join(done) + f" ok [{card}]", flush=True)


def stream_plain_ms(shape, dtype="f32"):
    """ms per step of the stream kernel's plain version on the card (host
    clock to a synchronise), K+3 steps: a full launch and a partial one."""
    import torch
    from slb2d_tpu_torch.ops import (stencil, stepper_cuda,
                                     stepper_stream_cuda as ssc)
    model, c, xs, runner = _stream_runner(shape, dtype)
    n = runner.geom.K + 3
    table = stepper_cuda.pack_xs_dict({k: v[:n] for k, v in xs.items()},
                                      model.np_dtype)
    st = stencil.bootstrap_state(c, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssc.run_chunk_plain_stream(c, st, table, 0, (), runner.geom)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def step_plain_ms(shape, dtype="f32", n=20):
    """ms per step of the step kernel's plain version (run_chunk_plain) on
    the card, host clock to a synchronise, n steps."""
    import torch
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    model, c, xs = _setup(shape, dtype, torch.device(DEVICE))
    table = stepper_cuda.pack_xs_dict({k: v[:n] for k, v in xs.items()},
                                      model.np_dtype)
    st = stencil.bootstrap_state(c, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepper_cuda.run_chunk_plain(c, st, table, 0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def cli_argv(shape, display=4, impl="cuda"):
    """MAIN_ARGV (BASELINE #4's physics) at another shape, display and
    impl."""
    return [a for a in MAIN_ARGV if a.split("=")[0] not in
            ("display", "n-harmonics", "g-grid", "impl")] + [
        f"display={display}", f"n-harmonics={shape['n_harmonics']}",
        f"g-grid={shape['g_grid']}", f"impl={impl}"]


def run_cli(argv, force_b1=False, form=None):
    """cli.main(argv) with every kernel count set to 0 just before and
    read just after; force_b1 makes impl=cuda's routing take B1, and form
    "per-half-step" makes B1's runner take that form (resident_plan finds
    no plan).  Returns (wall seconds, output text, launches of B1, B2, B3
    shared, B3 per-omega, launches of B1's resident and per-half-step
    forms and of B2's spill and tiling forms)."""
    import torch
    from slb2d_tpu_torch import cli
    from slb2d_tpu_torch.ops import (stepper_cuda, stepper_stream_cuda as
                                     sst, sweep_stack_cuda as ssc)
    rule, plan = sst.stream_beats_b1, stepper_cuda.resident_plan
    if force_b1:
        sst.stream_beats_b1 = lambda *a: False
    if form == "per-half-step":
        stepper_cuda.resident_plan = lambda *a, **k: None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.txt")
            torch.cuda.synchronize()
            stepper_cuda.launch_count = sst.launch_count = 0
            sst.spill_launch_count = sst.tiling_launch_count = 0
            stepper_cuda.resident_launch_count = 0
            stepper_cuda.per_half_step_launch_count = 0
            ssc.launch_count = ssc.omega_launch_count = 0
            t0 = time.perf_counter()
            rc = cli.main(argv + [f"o={path}"])
            wall = time.perf_counter() - t0  # ends in a fetch, which
                                             # synchronises
            counts = (stepper_cuda.launch_count, sst.launch_count,
                      ssc.launch_count, ssc.omega_launch_count)
            forms = (stepper_cuda.resident_launch_count,
                     stepper_cuda.per_half_step_launch_count,
                     sst.spill_launch_count, sst.tiling_launch_count)
            check(rc == 0, f"cli.main returned {rc}")
            with open(path) as fh:
                text = fh.read()
    finally:
        sst.stream_beats_b1, stepper_cuda.resident_plan = rule, plan
    return wall, text, counts, forms


def _rows(text):
    import numpy as np
    return np.array([l.split() for l in text.splitlines()
                     if l and not l.startswith("#")], float)


def stream_main_phase(card):
    """The CLI at the wide and the tall shape with impl=stream and
    impl=cuda (display 4; where the routing takes B2 also with it forced
    to B1, for the 13 columns of B2 against B1; at the tall grid also with
    B1 forced to its per-half-step form, for the 13 columns of its two
    forms), display 77 on impl=stream, and display 77 against display 4 at
    BASELINE #4 on B1.  Launches are checked per engine and B1 form.
    Returns {(shape name, engine or "cuda-b1 <form>"): (model, steps,
    launches of B1 and B2)} of the display-4 runs, and under (shape name,
    "impl=cuda") the unforced impl=cuda run's with its engine and form."""
    import numpy as np
    import torch
    from slb2d_tpu_torch.config import parse_cmd
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    out = {}
    walls = {}
    for name, shape in (("N=100 M=12000", WIDE), ("N=400 M=4000", TALL),
                        ("BASELINE#4", BASELINE4)):
        model = SuperlatticeModel(parse_cmd(cli_argv(shape)))
        steps = run_steps(model)
        records = run_chunks(model, 77)[1]
        routed = routed_engine(model)
        planned = planned_form(model)
        sites = 2 * (model.N + 1) * (model.M + 1) * steps
        # (impl, display, engine, routing forced to B1, B1 form forced)
        if shape is BASELINE4:
            runs = [("cuda", 4, "cuda-b1", True, None),
                    ("cuda", 77, "cuda-b1", True, None)]
        else:
            runs = ([("stream", 4, "stream", False, None),
                     ("cuda", 4, routed, False, None)]
                    + ([("cuda", 4, "cuda-b1", True, None)]
                       if routed == "stream" else [])
                    + ([("cuda", 4, "cuda-b1", True, "per-half-step")]
                       if shape is TALL and planned == "resident" else [])
                    + [("stream", 77, "stream", False, None)])
        lines = {}
        for impl, display, engine, force, form in runs:
            wall, text, counts, forms = run_cli(
                cli_argv(shape, display, impl), force_b1=force, form=form)
            form = ((form or planned) if engine == "cuda-b1"
                    else stream_form(model))
            tag = f"{engine} {form}"
            what = (f"cli display={display} {name} f32 impl={impl}"
                    f"{' (routing forced to B1)' if force else ''}")
            want = expected_launches(engine, steps,
                                     records if display == 77 else 0,
                                     form=form,
                                     chunks=run_chunks(model, display)[0])
            check((counts, forms) == want,
                  f"{what}: (B1, B2, B3, B3 per-omega), (B1 resident, B1 "
                  f"per-half-step, B2 spill, B2 tiling) launches "
                  f"{(counts, forms)}, expected {want} on {tag}")
            rows = _rows(text)
            check(bool(np.all(np.isfinite(rows))), f"{what}: non-finite")
            norm_err = float(np.max(np.abs(rows[:, 6] - 1.0)))
            check(norm_err < 1e-3, f"{what}: NORM {norm_err} from 1")
            if display == 4:
                check(rows.shape == (1, 13), f"{what}: {rows.shape} lines")
                lines[tag] = rows[0]
                out[name, tag] = (model, steps, counts[:2])
                if (impl, force, form) == ("cuda", False, planned):
                    out[name, "impl=cuda"] = (model, steps, counts[:2], tag)
            else:
                check(rows.shape == (records, 15),
                      f"{what}: {rows.shape}, expected {records} lines")
                check(bool(np.all(np.diff(rows[:, 13]) > 0)),
                      f"{what}: t not increasing")
            walls[display] = wall
            print(f"stream main: {what} [{tag}]: {steps} steps, "
                  f"launches B1 {counts[0]} (resident {forms[0]}, "
                  f"per-half-step {forms[1]}) B2 {counts[1]} (spill "
                  f"{forms[2]}, tiling {forms[3]}), "
                  f"{rows.shape[0]} line(s), max |NORM-1| {norm_err:.3e}, "
                  f"wall {wall:.3f} s, {sites / wall:.4e} site-updates/s "
                  f"[{card}]", flush=True)
        if shape is BASELINE4:
            print(f"stream main: display 77 vs display 4 at BASELINE#4 on "
                  f"B1 {planned}: {walls[77]:.3f} s vs {walls[4]:.3f} s "
                  f"({walls[77] / walls[4]:.3f}x) for {records} records "
                  f"[{card}]", flush=True)
        b1 = f"cuda-b1 {planned}"
        for other in ("stream tiling", "cuda-b1 per-half-step"):
            if other in lines and b1 in lines and other != b1:
                err = allclose(torch.as_tensor(lines[other]),
                               torch.as_tensor(lines[b1]),
                               what=f"{name} display-4 columns {other} vs "
                                    f"{b1}", **TOL["f32"])
                print(f"stream main: {name} the 13 display-4 columns of "
                      f"{other} vs {b1}: max abs err {err:.3e} (rtol 1e-4, "
                      f"atol 1e-7) [{card}]", flush=True)
    return out


def stream_routing_phase(card):
    """B1 in its resident and its per-half-step form and B2, per step
    (CUDA events, 2000 steps in one chunk, in turns: resident,
    per-half-step, B2, B2, per-half-step, resident), at BASELINE #4 and
    the two stream shapes: the measurement behind stream_beats_b1.  Where
    B1 (in the form the plan picks) and B2 differ by more than 10%, the
    rule must name the faster.  Returns {shape name: {"resident": [ms],
    "per-half-step": [ms], "stream": [ms]}}."""
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
    res, parts, wrong = {}, [], []
    for name, shape in (("BASELINE#4", BASELINE4), ("N=100 M=12000", WIDE),
                        ("N=400 M=4000", TALL)):
        m = SuperlatticeModel(SimConfig(display=4, t_start=10.0, **PHYS,
                                        **shape))
        planned = planned_form(m)
        fns = {form: (lambda f=form: engine_ms(shape, "cuda-b1", form=f))
               for form in ("resident", "per-half-step")
               if form == "per-half-step" or planned == "resident"}
        fns["stream"] = lambda: engine_ms(shape, "stream")
        order = list(fns) + list(fns)[::-1]
        t = {k: [] for k in fns}
        for k in order:
            t[k].append(fns[k]())
        mean = {k: sum(v) / len(v) for k, v in t.items()}
        b1, b2 = mean[planned], mean["stream"]
        rule = sst.stream_beats_b1(m.NHP, m.MP, m.np_dtype)
        g = sst.default_geometry(m.NHP, m.MP, 4)
        if abs(b1 - b2) > 0.1 * min(b1, b2) and rule != (b2 < b1):
            wrong.append(f"routing at {name}: B1 ({planned}) "
                         f"{b1 * 1e3:.3f} us, B2 {b2 * 1e3:.3f} us per step, "
                         f"but the rule picks {'B2' if rule else 'B1'}")
        res[name] = t
        parts.append(f"{name} (B2 W={g.W}, {g.n_tiles} tiles, "
                     f"{'shared' if g.smem else 'global'}): " + ", ".join(
                         f"{k} " + "/".join(f"{v * 1e3:.3f}" for v in vs)
                         for k, vs in t.items())
                     + f" us -> {'B2' if rule else 'B1 ' + planned}")
    print("stream routing (f32, per step, CUDA events, in turns): "
          + "; ".join(parts) + f" [{card}]", flush=True)
    check(not wrong, "; ".join(wrong))
    return res


# the first f32 shape past B1's resident plan that impl=cuda sends to B2
# (N=100 M=16000 still has a plan; M=17000 and M=20000 have none): B2's
# spill form
B2_OWN = dict(n_harmonics=100, g_grid=20000)


def turns(fns, order):
    """{name: [ms per step]} of engine_ms calls run in `order` (each name
    of fns twice, mirrored: a, b, b, a), fns[name] = engine_ms's
    arguments."""
    t = {k: [] for k in fns}
    for k in order:
        args, kwargs = fns[k]
        t[k].append(engine_ms(*args, **kwargs))
    return t


def mirrored(names):
    return list(names) + list(names)[::-1]


def fmt_turns(t):
    return ", ".join(f"{k} " + "/".join(f"{v * 1e3:.3f}" for v in vs)
                     for k, vs in t.items())


def b2_shape_phase(card):
    """B2 on the shape where impl=cuda runs it: N=100 M=20000 f32, BASELINE
    #4's physics.  The routing sends it to B2's spill form; the CLI there
    (the spill form's main path: every count set to 0 just before and read
    just after, one B2 launch per chunk); the spill form, the tiling form
    and B1's per-half-step form (the engines impl=cuda took before) per
    step, CUDA events, 2000 steps in one chunk, in turns; the main path's
    bound per step as bound_ms computes it for a display-4 run's steps and
    each engine's loss; what the spill form takes on the card.  Returns a
    dict of them."""
    import numpy as np
    from slb2d_tpu_torch.config import SimConfig, parse_cmd
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.ops import stepper_cuda, stepper_stream_cuda as sst
    sms = stepper_cuda.card_sms(DEVICE)
    m = SuperlatticeModel(SimConfig(display=4, t_start=10.0, **PHYS,
                                    **B2_OWN))
    choice = sst.engine_choice(m.NHP, m.MP, m.np_dtype, sms)
    check(choice == ("stream", "spill"),
          f"N=100 M=20000 f32: impl=cuda takes {choice}, not B2's spill "
          f"form past B1's residency")
    plan = sst.spill_plan(m.NHP, m.MP, m.np_dtype, sms)
    info = sst.spill_form_info(m.np_dtype, plan, m.NHP, m.MP)
    check(info["smem_bytes"] == plan.smem_bytes
          and info["threads"] == plan.threads
          and info["blocks_at_once"] >= plan.bands,
          f"B2 spill at N=100 M=20000: {plan} against the card's {info}")

    # the main path: the CLI, impl=cuda
    cli_model = SuperlatticeModel(parse_cmd(cli_argv(B2_OWN)))
    steps = run_steps(cli_model)
    chunks = run_chunks(cli_model, 4)[0]
    wall, text, counts, forms = run_cli(cli_argv(B2_OWN))
    want = expected_launches("stream", steps, form="spill", chunks=chunks)
    check((counts, forms) == want,
          f"cli N=100 M=20000 impl=cuda: (B1, B2, B3, B3 per-omega), (B1 "
          f"resident, B1 per-half-step, B2 spill, B2 tiling) launches "
          f"{(counts, forms)}, expected {want}")
    rows = _rows(text)
    check(rows.shape == (1, 13) and bool(np.all(np.isfinite(rows))),
          f"cli N=100 M=20000: {rows}")
    check(abs(rows[0, 6] - 1.0) < 1e-3, f"cli N=100 M=20000: NORM "
          f"{rows[0, 6]}")
    sites = 2 * (cli_model.N + 1) * (cli_model.M + 1) * steps
    print(f"stream own shape main: cli display=4 N=100 M=20000 f32 impl=cuda "
          f"[stream spill]: {steps} steps in {chunks} chunk(s), launches B1 "
          f"{counts[0]} B2 {counts[1]} (spill {forms[2]}, tiling "
          f"{forms[3]}), NORM={rows[0, 6]:.9f}, wall {wall:.3f} s, "
          f"{sites / wall:.4e} site-updates/s [{card}]", flush=True)

    # the three engines in turns, the bound, the losses
    own = {"spill": ((B2_OWN, "stream"), dict(form="spill")),
           "tiling": ((B2_OWN, "stream"), dict(form="tiling")),
           "per-half-step": ((B2_OWN, "cuda-b1"),
                             dict(form="per-half-step"))}
    t = turns(own, mirrored(own))
    flops = main_path_flops(m, steps, av_steps=window_steps(m, 10.0, steps))
    bound, by = bound_ms(m, steps, flops)
    loss = {k: steps * (sum(v) / len(v) - bound) * 1e-3 for k, v in t.items()}
    g = sst.default_geometry(m.NHP, m.MP, 4, sms=sms)
    print(f"stream own shape: N=100 M=20000 f32 (NHP={m.NHP}, MP={m.MP}): "
          f"impl=cuda -> B2 spill ({plan.bands} bands, R={plan.R}, "
          f"S={plan.S}, {plan.smem_bytes} B a block, slabs "
          f"{plan.spill_bytes} B; {info['registers']} registers, "
          f"{info['local_bytes']} spill bytes, {info['static_smem_bytes']} B "
          f"static, {info['blocks_at_once']} blocks at once); per step (CUDA "
          f"events, in turns) {fmt_turns(t)} us (tiling W={g.W}, "
          f"{g.n_tiles} tiles); bound {bound * 1e3:.4f} us ({by}) over "
          f"{steps} steps: loss " + ", ".join(
              f"{k} {v:.4f} s" for k, v in loss.items()) + f" [{card}]",
          flush=True)

    return {"shape": "N=100 M=20000", "steps": steps, "ms_turns": t,
            "bound_ms": bound, "bound_by": by, "loss_s": loss,
            "launches": forms[2], "wall_s": wall, "plan": plan._asdict(),
            "form_info": info, "tiling_W": g.W}, m


def _lanes_runner(shape, max_points=LANES_MAX_POINTS, cluster_size=None):
    """(sweep, its B4 runner) at one sweep check shape; cluster_size as
    LanesRunner takes it (None: lanes_cluster_plan's form, 0: the streaming
    form)."""
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, _ = _sweep_setup(shape, "f32", impl="torch")
    return sweep, slc.make_sweep_lanes_runner(
        sweep, max_points=max_points, cluster_size=cluster_size)


def lanes_form_name(runner):
    """'cluster CS=8' or 'streaming': the B4 form a runner launches."""
    return (f"cluster CS={runner.cluster_size}" if runner.form == "cluster"
            else "streaming")


def lanes_call_launches(runner, n):
    """B4 launches of one advance() call of n steps in the runner's form."""
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    if runner.form == "cluster":
        return slc.LAUNCHES_PER_CALL if n else 0
    return slc.LAUNCHES_PER_STEP * n


def _lanes_equal(x, y, what):
    """Raise unless x and y (tensors or numpy arrays) are equal element
    for element; returns their largest abs difference (0.0)."""
    import numpy as np
    import torch
    if isinstance(x, np.ndarray):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    err = float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
    check(torch.equal(x, y), f"{what} not bit for bit (max abs err "
          f"{err:.3e})")
    return err


def check_lanes_vs_plain(shape, max_points=LANES_MAX_POINTS, n_steps=None,
                         split=151, cluster_size=None):
    """Run the lane-packed kernel (in the form cluster_size picks, as
    _lanes_runner takes it) and its plain version from each chunk's
    bootstrap over the same steps, split across calls at step `split`
    (odd: the second call starts at parity 1 and its loop t continues);
    n_steps=None runs to the sweep's end.  State, per-lane av and capture
    rows and the host segment sums bit for bit; the launches per call of
    the form.  Returns (the largest abs difference, 0.0, the runner)."""
    import numpy as np
    import torch
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, runner = _lanes_runner(shape, max_points, cluster_size)
    n = n_steps or sweep.n_steps
    what = (f"lanes {shape} B={sweep.B} max_points={max_points} "
            f"{lanes_form_name(runner)} {n} steps")
    err = 0.0
    sums = []
    for k, pack in enumerate(runner.packs):
        launches0 = runner.launches
        kern = runner.advance(k, runner.start(k), split)
        kern = runner.advance(k, kern, n - split, step0=split)
        plain = slc.run_lanes_plain(pack, runner.start(k), split)
        plain = slc.run_lanes_plain(pack, plain, n - split, split,
                                    runner.loop_t(split))
        torch.cuda.synchronize()
        want = (lanes_call_launches(runner, split)
                + lanes_call_launches(runner, n - split))
        check(runner.launches - launches0 == want,
              f"{what}: {runner.launches - launches0} launches (expected "
              f"{want})")
        for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
            err = max(err, _lanes_equal(getattr(kern, f), getattr(plain, f),
                                        f"{what} chunk {k} {f}"))
        (kav, kcap, _), (pav, pcap, _) = (slc.finish_chunk(pack, kern),
                                          slc.finish_chunk(pack, plain))
        for x, y, f in ((kav, pav, "av sums"), (kcap, pcap, "cap sums")):
            err = max(err, _lanes_equal(x, y, f"{what} {f}"))
        sums.append((kav, kcap))
    av = np.concatenate([a for a, _ in sums])
    cap = np.concatenate([c for _, c in sums], axis=1)
    egate = np.array([float(m.E_omega) > 0 for m in sweep.models])
    check(bool(np.all(av[~egate] == 0)) and bool(np.all(av[egate, 0] > 0)),
          f"{what}: the dc-only points averaged or a point never did")
    if n == sweep.n_steps:
        # run to the end: the schedule's counts and every capture fired
        check(np.array_equal(av[:, 0], expected_av_counts(sweep)),
              f"{what}: av counts differ from the schedule")
        check(bool(np.all(cap[3] != 0)), f"{what}: a capture never fired")
    return err, runner


def check_lanes_forms(shape, max_points):
    """B4's cluster form (the plan's) against its streaming form over the
    whole sweep from each chunk's bootstrap, one call per chunk as the
    bench runs them: state, per-lane rows and host segment sums bit for
    bit.  Returns the cluster-form runner."""
    import torch
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, clu = _lanes_runner(shape, max_points)
    check(clu.form == "cluster", f"lanes {shape}: the {clu.form} form")
    stm = slc.make_sweep_lanes_runner(sweep, max_points=max_points,
                                      cluster_size=0)
    n = sweep.n_steps
    what = (f"lanes {shape} max_points={max_points} {lanes_form_name(clu)} "
            f"vs streaming, {n} steps")
    for k, pack in enumerate(clu.packs):
        got = clu.advance(k, clu.start(k), n)
        ref = stm.advance(k, stm.start(k), n)
        torch.cuda.synchronize()
        for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
            _lanes_equal(getattr(got, f), getattr(ref, f),
                         f"{what} chunk {k} {f}")
        for x, y, f in zip(slc.finish_chunk(pack, got)[:2],
                           slc.finish_chunk(pack, ref)[:2],
                           ("av sums", "cap sums")):
            _lanes_equal(x, y, f"{what} chunk {k} {f}")
    check(clu.launches == len(clu.packs) * slc.LAUNCHES_PER_CALL
          and stm.launches == len(clu.packs) * slc.LAUNCHES_PER_STEP * n,
          f"{what}: launches {clu.launches}, {stm.launches}")
    return clu


LANES_SHAPES = (("lanes3", LANES_MAX_POINTS, None),
                ("omega_ragged", LANES_MAX_POINTS, None),
                ("omega_ragged", 2, None),
                ("full", LANES_MAX_POINTS, 300),
                ("full", SWEEP_POINTS, 300))


def lanes_forms_phase(card):
    """What each form of B4 takes on the card at every chunk of phase 16:
    registers and spill bytes a thread, shared memory a block and the
    clusters (streaming form: blocks) that run at once, for the plan's
    cluster size and the streaming form.  Raises where the plan's cluster
    cannot run on the card.  Returns {(shape, max_points): {cluster size:
    form_info}}."""
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    out = {}
    for shape, mp, _ in LANES_SHAPES:
        sweep, runner = _lanes_runner(shape, mp)
        NHP, MP = sweep.base.NHP, sweep.base.MP
        check(runner.form == "cluster", f"lanes {shape} max_points={mp}: "
              f"the plan gives the {runner.form} form")
        out[shape, mp] = {cs: slc.form_info(cs, NHP, MP, runner.CB)
                          for cs in (runner.cluster_size, 0)}
        info = out[shape, mp][runner.cluster_size]
        check(info["active_clusters"] > 0 and info["smem_bytes"]
              == runner.smem_bytes, f"lanes {shape} CB={runner.CB} CS="
              f"{runner.cluster_size}: {info}")
    print("lanes forms: B4 on the card, (shape, max_points): cluster size "
          "(0: streaming) registers, spill bytes, shared bytes a block, "
          "clusters (blocks) at once: " + "; ".join(
              f"{sh} {mp}: " + ", ".join(
                  f"CS={cs} {v['registers']}/{v['local_bytes']}/"
                  f"{v['smem_bytes']}/{v['active_clusters']}"
                  for cs, v in forms.items())
              for (sh, mp), forms in out.items()) + f" [{card}]",
          flush=True)
    return out


def lanes_kernel_ms(max_points=LANES_MAX_POINTS, n_plain=20):
    """ms per step of the lane-packed kernel's cluster and streaming form
    over the whole 64-point sweep (CUDA events; every chunk from its
    bootstrap, one call per chunk, as the bench runs them; in turns:
    cluster, streaming, streaming, cluster) and of its plain version (host
    clock, n_plain steps of every chunk): ([cluster ms], [streaming ms],
    plain ms, the cluster-form runner)."""
    import torch
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, runner = _lanes_runner("full", max_points)
    check(runner.form == "cluster", f"the 64-point sweep's B4 form is "
          f"{runner.form}")
    stm = slc.make_sweep_lanes_runner(sweep, max_points=max_points,
                                      cluster_size=0)
    n = sweep.n_steps
    chunks = range(len(runner.packs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in chunks:
        slc.run_lanes_plain(runner.packs[k], runner.start(k), n_plain)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    k_ms, s_ms = in_turns(
        lambda: [runner.advance(k, runner.start(k), n) for k in chunks],
        lambda: [stm.advance(k, stm.start(k), n) for k in chunks], n)
    return k_ms, s_ms, p_ms, runner


def lanes_sizes_ms():
    """The plan's cluster size against the others that hold a point of the
    64-point sweep (NHP=48, MP=512): the clusters of each size 1-8 that
    run at once on this card (at 2 rows a rank, NHP = 2 x size, MP=128:
    a block of 1024 threads takes an SM whatever its shared memory), and
    ms per step of the whole sweep (CUDA events, in turns, each size
    twice) in chunks of 16 at 4, 6 and 8 blocks a point and in one chunk
    of 64 at 2, 3 and 4.  Returns ({size: clusters at once}, {max_points:
    {size: [ms]}})."""
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    at_once = {cs: slc.form_info(cs, 2 * cs, 128, 1)["active_clusters"]
               for cs in slc.CLUSTER_SIZES}
    out = {}
    for mp, sizes in ((LANES_MAX_POINTS, (4, 6, 8)),
                      (SWEEP_POINTS, (2, 3, 4))):
        fns = {}
        for cs in sizes:
            sweep, r = _lanes_runner("full", mp, cluster_size=cs)
            fns[cs] = (lambda r=r: [r.advance(k, r.start(k), sweep.n_steps)
                                    for k in range(len(r.packs))])
        for fn in fns.values():
            fn()
        t = {cs: [] for cs in sizes}
        for cs in list(sizes) + list(sizes)[::-1]:
            t[cs].append(time_per_step(fns[cs], sweep.n_steps, warm=False))
        out[mp] = t
    return at_once, out


# the fixed cost of a cluster-form step: 16 points of a grid so small that
# each thread has one cell a phase (NHP=8, MP=128)
LANES_TINY = dict(n_harmonics=6, g_grid=29, t_start=0.1)


def lanes_fixed_ms(n_steps=4000):
    """ms per step of one chunk of 16 points at N=6 M=29 (one cell a
    thread a phase: the fixed cost of a step, the two phases' latency, the
    two cluster barriers and the av update) at 1, 2 and 4 blocks a point
    and on the streaming form (CUDA events, after a warm-up).  Returns
    {cluster size (0: streaming): ms}."""
    import numpy as np
    import torch
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    from slb2d_tpu_torch.parallel.sweep import ParameterSweep
    cfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True,
                    **{**PHYS, **LANES_TINY})
    sweep = ParameterSweep(cfg, {"E_dc": np.linspace(0.1, 3.0, 16)},
                           device=torch.device(DEVICE))
    out = {}
    for cs in (1, 2, 4, 0):
        r = slc.make_sweep_lanes_runner(sweep, cluster_size=cs)
        out[cs] = time_per_step(lambda: r.advance(0, r.start(0), n_steps),
                                n_steps)
    return out


def lanes_call_ms():
    """Wall seconds of the bench's runner() over the 64-point sweep in
    chunks of 16 (a fetch after each chunk) and of the same parts with
    every chunk enqueued before the first fetch (overlapped), host clock,
    in turns (runner, overlapped, overlapped, runner, twice) after one
    warm call each; the two results bit for bit.  Returns {"runner": [s],
    "overlapped": [s]}."""
    import numpy as np
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, runner = _lanes_runner("full")
    n = sweep.n_steps

    def overlapped():
        sts = [runner.advance(k, runner.start(k), n)
               for k in range(len(runner.packs))]
        out = [slc.finish_chunk(p, st) for p, st in zip(runner.packs, sts)]
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out], axis=1),
                [np.concatenate([o[2][i] for o in out], axis=1)
                 for i in range(4)])

    fns = {"runner": runner, "overlapped": overlapped}
    res = {k: fn() for k, fn in fns.items()}
    out = {k: [] for k in fns}
    for k in ("runner", "overlapped", "overlapped", "runner") * 2:
        t0 = time.perf_counter()
        fns[k]()
        out[k].append(time.perf_counter() - t0)
    (av1, cap1, st1), (av2, cap2, st2) = res["runner"], res["overlapped"]
    check(np.array_equal(av1, av2)
          and np.array_equal(np.stack([cap1[k] for k in slc.CAP_KEYS]),
                             cap2)
          and all(np.array_equal(x, y) for x, y in zip(st1, st2)),
          "the overlapped chunks and runner() differ")
    return out


def _bench_line(argv):
    """`python -m slb2d_tpu_torch.bench argv` as a subprocess: its one
    JSON line, checked for a finite value."""
    proc = subprocess.run([sys.executable, "-m", "slb2d_tpu_torch.bench",
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"bench {' '.join(argv)}: rc {proc.returncode}, stdout "
          f"{proc.stdout[-500:]!r}, stderr {proc.stderr[-1500:]}")
    line = json.loads(lines[0])
    check(isinstance(line.get("value"), float)
          and line["value"] == line["value"] and line["value"] > 0,
          f"bench {' '.join(argv)}: value {line.get('value')}")
    return line


def lanes_main_phase(card):
    """The bench's sweep lanes mode as a user runs it, then its bench
    function in this process against B3 on the same sweep.  Returns (B4
    launches of the bench run, its wall, steps, the sweep)."""
    import numpy as np
    from slb2d_tpu_torch import bench
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    line = _bench_line(["sweep", "lanes"])
    check(line["device"] == card and "B4" in line["metric"],
          f"bench sweep lanes line {line}")
    sweep = bench.make_sweep(device=DEVICE)
    chunks = -(-sweep.B // LANES_MAX_POINTS)
    per_call = slc.LAUNCHES_PER_CALL * chunks   # the cluster form
    want = dict.fromkeys(("B1", "B1 resident", "B1 per-half-step", "B2",
                          "B3", "B3 per-omega"), 0)
    want["B4"] = 2 * per_call                 # the warm and the timed call
    check(line["launches"] == want,
          f"bench sweep lanes launches {line['launches']}, expected {want}")
    print(f"lanes main: python -m slb2d_tpu_torch.bench sweep lanes: "
          f"{line['value']:.4e} site-updates/s, wall {line['wall_s']:.4f} "
          f"s for {line['steps']} steps, B4 launches {want['B4']} (cluster "
          f"form, {chunks} chunks x 2 calls) [{line['device']}]",
          flush=True)

    zero_counts()
    ups, wall, steps, (sweep, (av, cap, _)) = bench.bench_sweep(
        "lanes", device=DEVICE)
    got = bench.launch_counts()
    check(got == {**want, "B4": 2 * per_call},
          f"bench_sweep lanes launches {got}")
    forms = (slc.cluster_launch_count, slc.streaming_launch_count)
    check(forms == (2 * per_call, 0),
          f"bench_sweep lanes (cluster, streaming) launches {forms}, "
          f"expected {(2 * per_call, 0)}")
    want_counts = expected_av_counts(sweep)
    check(np.array_equal(av[:, 0], want_counts),
          f"B4 av counts differ from the schedule at "
          f"{np.flatnonzero(av[:, 0] != want_counts)[:8].tolist()}")
    res = slc.observables(sweep, av, cap)
    b3 = bench.make_sweep(device=DEVICE)
    check(b3.engine == "cuda", f"the B3 reference ran on {b3.engine}")
    ref = b3.run()
    check(np.array_equal(res["av_count"], ref["av_count"]),
          "B4 and B3 av counts differ")
    worst = 0.0
    for k in OBS:
        g, r = np.asarray(res[k], float), np.asarray(ref[k], float)
        e = np.abs(g - r)
        check(bool(np.all(e <= 2e-5 + 2e-4 * np.abs(r))),
              f"B4 vs B3 {k}: outside 2e-4 rel / 2e-5 abs, max abs err "
              f"{e.max():.3e}")
        worst = max(worst, float(e.max()))
    _, s_wall, s_steps, _ = bench.bench_sweep("stack", K=sweep.n_steps,
                                              device=DEVICE)
    print(f"lanes main: bench_sweep lanes in process: {steps} steps, wall "
          f"{wall:.4f} s = {wall / steps * 1e3:.5f} ms/step "
          f"({ups:.4e} site-updates/s); av_count = schedule for all "
          f"{sweep.B} points; vs B3 on the same sweep: av_count exact, max "
          f"abs err {worst:.3e} (2e-4 rel / 2e-5 abs); B3 (SweepStackRunner, "
          f"{s_steps} steps) wall {s_wall:.4f} s = "
          f"{s_wall / s_steps * 1e3:.5f} ms/step [{card}]", flush=True)
    return line["launches"]["B4"], line["wall_s"], line["steps"], sweep


def zero_counts():
    """Set every kernel's launch count to 0 (bench.launch_counts reads
    them)."""
    from slb2d_tpu_torch.ops import (stepper_cuda, stepper_stream_cuda,
                                     sweep_lanes_cuda, sweep_stack_cuda)
    from slb2d_tpu_torch.perf import (roll_cost_experiment,
                                      transposed_experiment, vpu_roofline)
    for mod in (stepper_cuda, stepper_stream_cuda, sweep_lanes_cuda,
                sweep_stack_cuda, vpu_roofline, transposed_experiment):
        mod.launch_count = 0
    stepper_cuda.resident_launch_count = 0
    stepper_cuda.per_half_step_launch_count = 0
    sweep_stack_cuda.omega_launch_count = 0
    sweep_lanes_cuda.cluster_launch_count = 0
    sweep_lanes_cuda.streaming_launch_count = 0
    sweep_stack_cuda.cluster_launch_count = 0
    sweep_stack_cuda.streaming_launch_count = 0
    roll_cost_experiment.register_launch_count = 0
    roll_cost_experiment.pass_launch_count = 0
    transposed_experiment.resident_launch_count = 0
    transposed_experiment.per_half_step_launch_count = 0


def _check_b1_forms(what, launches, engine):
    """B1's launches split by form add up, and a run that names B1's form
    ([cuda-b1 resident] or [cuda-b1 per-half-step]) launched that form
    and not the other."""
    per_form = launches["B1 resident"] + launches["B1 per-half-step"]
    check(launches["B1"] == per_form, f"{what}: B1 launches {launches}")
    for form, other in (("resident", "per-half-step"),
                        ("per-half-step", "resident")):
        if engine == f"cuda-b1 {form}":
            check(launches[f"B1 {form}"] > 0
                  and launches[f"B1 {other}"] == 0,
                  f"{what} on {engine}: launches {launches}")


def bench_modes_phase(card):
    """Every other bench mode once: one parseable line with a finite
    value each (subprocesses for the two kernel driver modes; in this
    process the rest, the plain engines' modes at a cut depth), B1's
    launches per form where a mode ran B1, and movie refused."""
    import io
    import math
    import re
    from slb2d_tpu_torch import bench
    out = []
    for argv in (["driver", "cuda", "exact", "4"],
                 ["driver", "stream", "exact", "77"]):
        line = _bench_line(argv)
        check(line["device"] == card, f"bench {argv}: device {line}")
        engine = re.search(r"\[([^\]]+)\]", line["metric"]).group(1)
        _check_b1_forms(f"bench {argv}", line["launches"], engine)
        out.append(line)
    for argv, depth in (
            (["auto"], {}),
            (["driver", "torch", "fast", "4"],
             dict(N=8, M=64, omega=10.0, t_start=0.01, reps=2)),
            (["cuda"], {}), (["stream"], {}), (["f64"], {}),
            (["torch", "400", "20"], dict(chunk=100, reps=2)),
            (["sweep", "torch"], dict(K=100, reps=2)),
            (["sweep", "stack"], {}), (["sweep", "stack", "omega"], {})):
        zero_counts()
        rec = bench.run_mode(argv, DEVICE, **depth)
        launches = bench.launch_counts()
        # the B1 runner modes take the plan's form: resident at BASELINE
        # #4 in f32 and f64
        named = re.search(r"\[([^\]]+)\]", rec["metric"])
        engine = ("cuda-b1 resident" if argv[0] in ("cuda", "f64")
                  else named.group(1) if named else None)
        _check_b1_forms(f"bench {argv}", launches, engine)
        line = json.loads(json.dumps({**rec, "device": card,
                                      "launches": launches}))
        check(math.isfinite(line["value"]) and line["value"] > 0,
              f"bench {argv}: value {line['value']}")
        out.append(line)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench.main(["movie"])
    lines = buf.getvalue().strip().splitlines()
    movie = json.loads(lines[-1]) if lines else {}
    check(rc == 1 and len(lines) == 1 and movie.get("value") is None
          and "ROADMAP" in movie.get("error", ""),
          f"bench movie: rc {rc}, {lines}")
    for line in out:
        b1 = line["launches"]
        print(f"bench: {line['metric']}: {line['value']:.4e} "
              f"{line['unit']}, wall {line['wall_s']:.4f} s for "
              f"{line['steps']} steps; B1 launches resident "
              f"{b1['B1 resident']}, per-half-step {b1['B1 per-half-step']} "
              f"[{card}]", flush=True)
    print(f"bench: movie refused (exit 1): {movie['error']}", flush=True)
    return out


def vpu_phase(card, lib_path, reps=3):
    """P1: the chain kernel against its plain version at the probe's full
    shape over `reps` turns, both variants at every (ILP, block) pair it
    was built for, bit for bit; the SASS of every instance (its turn loop
    FMUL + FADD, or FFMA, and the loop control alone); then the probe's
    main path, vpu_roofline.run at REPS turns with each variant at its
    CHOSEN pair, its launches counted.  Returns (its result, its launches,
    the plain version's ms per turn, the max abs error, the SASS counts,
    the FP32 pipes' rate at the highest sampled SM clock)."""
    import torch
    from slb2d_tpu_torch.perf import (clock_line, time_ms, vpu_roofline as vr,
                                      with_clocks)
    coef, bias, x = vr.make_coeffs()
    xt = torch.from_numpy(x).to(DEVICE)
    err = 0.0
    for fma in (False, True):
        ref = vr.chain_plain(xt, coef, bias, reps, fma)
        check(bool(torch.isfinite(ref).all()), "P1: the plain chain overflowed")
        for ilp in vr.ILPS:
            for block in vr.BLOCKS:
                got = vr.chain(xt, coef, bias, reps, fma=fma, ilp=ilp,
                               block=block)
                e = float((got - ref).abs().max())
                err = max(err, e)
                check(torch.equal(got, ref),
                      f"P1 {vr.VARIANTS[fma]} ilp={ilp} block={block}: not "
                      f"bit for bit with its plain version, max abs err "
                      f"{e:.3e}")
    plain_ms = time_ms(lambda: vr.chain_plain(xt, coef, bias, 1), DEVICE, 1)
    counts = vr.sass_counts(lib_path)
    vr.check_sass(counts)
    zero_counts()
    res, samples = with_clocks(lambda: vr.run(
        DEVICE, configs={v: [vr.CHOSEN[v]] for v in vr.VARIANTS}))
    launches = vr.launch_count
    want = len(vr.VARIANTS) * 4             # a warm-up and 3 timed calls
    check(launches == want, f"P1 main path: {launches} launches, expected "
          f"{want}")
    mb, fb = res["best"]["mul+add"], res["best"]["fma"]
    print(f"P1 vpu_chain: vs plain at {vr.NHP}x{vr.MP}, {reps} turns, "
          f"mul+add and fma at ilp {'/'.join(map(str, vr.ILPS))} x block "
          f"{'/'.join(map(str, vr.BLOCKS))}: bit for bit (max abs err "
          f"{err:.3e}); SASS: {vr.sass_line(counts)} [{card}]", flush=True)
    print(f"P1 rate: mul+add {res['rate']:.6e} op/s (ilp={mb['ilp']} "
          f"block={mb['block']}, {mb['ms']:.4f} ms per call of {vr.REPS} "
          f"turns; {vr.shares_line(res['rate'], samples)}), fma "
          f"{res['fma_rate']:.6e} FMA/s = {2 * res['fma_rate']:.6e} flop/s "
          f"(ilp={fb['ilp']} block={fb['block']}, {fb['ms']:.4f} ms; "
          f"{vr.shares_line(res['fma_rate'], samples)}); plain version "
          f"{plain_ms:.4f} ms per turn; {launches} launches; "
          f"{clock_line(samples)} [{card}]", flush=True)
    return res, launches, plain_ms, err, counts, vr.pipe_rate(samples)


def roll_phase(card, k_check=5, k_refresh=100):
    """P2: both kernels against the plain version at the probe's full
    shape, k_check and k_refresh passes (the register kernel's halo
    refreshed three times at T=32), both forms and axes, bit for bit; then
    the probe's main path, roll_cost_experiment.run, with its launches
    counted.  Returns (its result, its launches per kernel, the plain
    version's ms per pass of form two along axis 1, the max abs error per
    kernel)."""
    import torch
    from slb2d_tpu_torch.perf import roll_cost_experiment as rce, time_ms
    x, y = (torch.from_numpy(a).to(DEVICE) for a in rce.make_inputs())
    inputs = {"two": [x, y], "one": [torch.cat([x, y], 0)]}
    err = {kernel: 0.0 for kernel in rce.KERNELS}

    def hold(what, kernel, got, ref):
        e = max(float((g - r).abs().nan_to_num().max())
                for g, r in zip(got, ref))
        err[kernel] = max(err[kernel], e)
        check(all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"P2 {what}: not bit for bit with the plain version, max abs "
              f"err {e:.3e}")

    for axis in rce.AXES:
        for form, arrays in inputs.items():
            for k in (k_check, k_refresh):
                ref = rce.roll_plain(arrays, axis, k)
                for kernel, fn in rce.KERNELS.items():
                    hold(f"{kernel} axis {axis} form {form} K={k}", kernel,
                         fn(arrays, axis, k), ref)
    plain_ms = time_ms(lambda: rce.roll_plain(inputs["two"], 1, k_check),
                       DEVICE, 1) / k_check
    zero_counts()
    res = rce.run(DEVICE)
    launches = {"registers": rce.register_launch_count,
                "passes": rce.pass_launch_count}
    calls = len(rce.AXES) * 4               # a warm-up and 3 timed calls
    want = {"registers": calls * len(rce.FORMS), "passes": calls * 3 * rce.K}
    check(launches == want, f"P2 main path launches {launches}, expected "
          f"{want}")
    t = {(r["kernel"], r["axis"], r["form"]): r["us_per_pass"]
         for r in res["records"]}
    plans = {f"axis {a} lines of {n}": rce.register_plan(n)
             for a, n in ((1, rce.MP), (0, rce.NH), (0, 2 * rce.NH))}
    print(f"P2 roll: vs plain at 2x{rce.NH}x{rce.MP}, {k_check} and "
          f"{k_refresh} passes, both kernels, forms and axes: bit for bit "
          f"(max abs err " +
          ", ".join(f"{k} {e:.3e}" for k, e in err.items()) + "); register "
          f"forms {plans}; us per pass " +
          "; ".join(f"{k} axis {a}: two {t[k, a, 'two']:.4f}, one "
                    f"{t[k, a, 'one']:.4f} (one/two "
                    f"{res['one_over_two'][f'{k} axis {a}']:.3f})"
                    for k in rce.KERNELS for a in rce.AXES) +
          f"; plain version {plain_ms * 1e3:.4f} us per pass; launches "
          f"{launches} [{card}]", flush=True)
    return res, launches, plain_ms, err


def transposed_phase(card, n_steps=200, split=101):
    """P3: both forms of the transposed kernel against its plain version,
    B1's plain version (av off) transposed, at BASELINE #4 over n_steps in
    two chunks (the second from parity 1): the state, transposed back, bit
    for bit, one launch a chunk on the resident form and two a step on the
    other; then the probe's main path, transposed_experiment.run (K steps
    on both forms and both forms of B1, every state bit for bit, the four
    timed in turns), with its launches per form counted; then what each
    form takes on the card against the resident plan.  Returns (its
    result, its launches per form, the plain version's ms per step, the
    max abs error, the model, the TConsts, the forms' info)."""
    import torch
    from slb2d_tpu_torch.perf import transposed_experiment as te
    model, c, tc, state0, xs = te.setup(DEVICE, steps=n_steps)
    plan = te.resident_plan(model.NHP, model.MP, tc.NHL,
                            te.card_sms(DEVICE))
    check(plan is not None and plan.bands <= te.card_sms(DEVICE),
          f"P3: resident plan {plan}")
    plain = te.transpose_state(state0)
    kern = {form: te.transpose_state(state0) for form in te.FORMS}
    plain_s, err = 0.0, 0.0
    for part, parity in ((xs[:split], 0), (xs[split:], split % 2)):
        for form in te.FORMS:
            launches0 = te.launch_count
            kern[form] = te.run_chunk(tc, kern[form], part, parity,
                                      form=form)
            want = (te.LAUNCHES_PER_CHUNK if form == "resident"
                    else te.LAUNCHES_PER_STEP * len(part))
            check(te.launch_count - launches0 == want,
                  f"P3 {form}: {te.launch_count - launches0} launches for "
                  f"{len(part)} steps")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = te.run_chunk_plain(tc, plain, part, parity)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        ref = te.untranspose(plain, model.NHP)
        for form, st in kern.items():
            got = te.untranspose(st, model.NHP)
            for f, v in ref.items():
                e = float((got[f] - v).abs().max())
                err = max(err, e)
                check(torch.equal(got[f], v), f"P3 {form} {f}: not B1's "
                      f"plain version bit for bit, max abs err {e:.3e}")
            check(bool((st.a[:, model.NHP:] == 0).all()),
                  f"P3 {form}: a padding column was written")
    check(bool(plain.a.abs().max() > 0), "P3: the state is zero")
    zero_counts()
    res = te.run(DEVICE)
    launches = {"resident": te.resident_launch_count,
                "per-half-step": te.per_half_step_launch_count}
    calls = 1 + 2 * 4      # the checked run, then 2 turns of a warm-up + 3
    want = {"resident": calls * te.LAUNCHES_PER_CHUNK,
            "per-half-step": calls * te.LAUNCHES_PER_STEP * te.K}
    check(launches == want and te.launch_count == sum(want.values()),
          f"P3 main path: {launches} launches, expected {want}")
    plain_ms = plain_s * 1e3 / n_steps
    info = te.form_info(plan, model.NHP, model.MP, tc.NHL)
    check(info["resident"]["smem_bytes"] == plan.smem_bytes
          and info["resident"]["threads"] == plan.threads
          and info["resident"]["blocks_at_once"] >= plan.bands,
          f"P3: {plan} against the card's {info['resident']}")
    print(f"P3 transposed: both forms vs their plain version, B1's (av "
          f"off), at BASELINE#4 (MP={model.MP}, NHL={tc.NHL}), {n_steps} "
          f"steps in 2 chunks: bit for bit (max abs err {err:.3e}); main "
          f"path {te.K} steps, every state bit for bit, us per step in "
          f"turns: " + "; ".join(f"{k} " + "/".join(f"{v:.4f}" for v in vs)
                                 for k, vs in res["us_turns"].items()) +
          f"; resident plan {plan}; plain version {plain_ms:.4f} ms/step; "
          f"launches {launches}; forms on the card {info} [{card}]",
          flush=True)
    return res, launches, plain_ms, err, model, tc, info


def probe_bounds(p3_model, p3_tc, p1_rate):
    """{probe: ((ms, by) at the data sheet, at P1's measured rate)} per
    turn (P1), pass (P2) and step (P3): the larger of the operations the
    probe's function needs on these inputs and its bytes, each input read
    once and each output written once."""
    from slb2d_tpu_torch.perf import roll_cost_experiment as rce
    from slb2d_tpu_torch.perf import transposed_experiment as te
    from slb2d_tpu_torch.perf import vpu_roofline as vr
    n1 = vr.NHP * vr.MP
    n2 = 2 * rce.NH * rce.MP
    m, tc = p3_model, p3_tc
    p3_flops = main_path_flops(m, te.K)
    p3_bytes = 4 * (2 * 4 * m.MP * tc.NHL + 2 * m.MP * tc.NHL + te.K * 10
                    + 2 * m.NHP + m.MP)
    work = {"P1": (2 * n1 * vr.K * vr.REPS, 8 * n1, vr.REPS),
            "P2": (n2 * rce.K, 8 * n2, rce.K),
            "P3": (p3_flops, p3_bytes, te.K)}
    return {k: (bound_of(*w, F32_OPS_PEAK), bound_of(*w, p1_rate))
            for k, w in work.items()}


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
    from slb2d_tpu_torch.ops import _build, stencil

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

    # 3. kernel vs plain on the card, both forms; the forms against each
    # other; what the resident form takes on the card, its barrier cost and
    # the cell code in SASS
    max_err = {}
    for shape_name, shape in (("BASELINE#4", BASELINE4), ("N8M64", SMALL)):
        for dtype in ("f64", "f32"):
            for form in ("resident", "per-half-step"):
                max_err[shape_name, dtype, form] = check_kernel_vs_plain(
                    shape, dtype, form=form)[0]
    for shape_name, shape in (("N=400 M=4000", TALL),
                              ("N=100 M=12000", WIDE)):
        for form in ("resident", "per-half-step"):
            max_err[shape_name, "f32", form] = check_kernel_vs_plain(
                shape, "f32", n_steps=200, form=form)[0]
    print("kernel: vs plain, both forms, 500 steps (200 at N=400 M=4000 and "
          "N=100 M=12000) in 2 chunks + d77 records, state and edges bit "
          "for bit: " +
          ", ".join(f"{s} {d} {f} av/records max abs err {e:.3e}"
                    for (s, d, f), e in max_err.items()) + " ok", flush=True)
    forms_err = {name: check_resident_vs_per_half_step(shape) for name, shape
                 in (("BASELINE#4", BASELINE4), ("N=100 M=12000", WIDE),
                     ("N=400 M=4000", TALL))}
    print("kernel forms: B1 resident vs per-half-step over 203 steps f32 "
          "with d77 records, state and edges bit for bit: " +
          ", ".join(f"{s} av/records max abs err {e:.3e}"
                    for s, e in forms_err.items()) + f" ok [{card}]",
          flush=True)
    b1_forms = b1_forms_phase(card)
    barrier_res, barrier_per = barrier_phase(card)
    b1_sass_counts = b1_sass(lib.path)
    k_ms, chunk_ms = kernel_ms(BASELINE4, "f32")
    print(f"kernel time BASELINE#4 f32: {k_ms:.5f} ms/step (resident form, "
          f"CUDA events), extra chunk {chunk_ms:.4f} ms [{card}]",
          flush=True)

    # 4. goldens through impl=cuda
    golden_phase(card)

    # 5. the main path (impl=cuda: the engine the routing picks), then the
    # plain path's rate over 2000 steps
    wall, steps, _ = main_path_phase(card)
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

    # 6. the sweep kernel against its plain version (the form the plan
    # picks: clusters at both shapes), what each form takes on the card,
    # and the two forms' times in turns
    sweep_err = {}
    for shape in ("full", "ragged"):
        for dtype in ("f64", "f32"):
            err, runner = check_sweep_kernel_vs_plain(shape, dtype)
            check(runner.form == "cluster", f"{shape} {dtype}: the "
                  f"{runner.form} form, not the cluster form")
            sweep_err[shape, dtype] = err, form_name(runner)
    print("sweep kernel: vs plain, 300 steps in 2 chunks, state and edges "
          "bit for bit, dc-only av 0: " +
          ", ".join(f"{s} {d} {f} av max abs err {e:.3e}"
                    for (s, d), (e, f) in sweep_err.items()) + " ok",
          flush=True)
    forms = forms_phase(card)
    sk, ss, sp_ms, se_ms, sweep = sweep_kernel_ms()
    sk_ms, ss_ms = sum(sk) / len(sk), sum(ss) / len(ss)
    per_step = 2 * (sweep.base.N + 1) * (sweep.base.M + 1) * sweep.B
    print(f"sweep kernel time {SWEEP_POINTS}-point N=40 M=500 f32 (1 launch "
          f"per chunk, CUDA events, in turns): cluster form "
          f"{', '.join(f'{v:.5f}' for v in sk)} ms/step, streaming form "
          f"{', '.join(f'{v:.5f}' for v in ss)} ms/step; plain version "
          f"{sp_ms:.5f} ms/step, batched torch engine "
          f"{se_ms:.5f} ms/step = {per_step / (se_ms * 1e-3):.4e} "
          f"site-updates/s (host clock) [{card}]", flush=True)

    # 7. the sweep main path
    sweep_launches, sweep_wall, sweep_steps = sweep_main_phase(card)

    # 8. the per-omega kernel against its plain version, and its times
    omega_err = {}
    for shape in ("omega_ragged", "omega16x4"):
        for dtype in ("f64", "f32"):
            omega_err[shape, dtype] = check_omega_kernel_vs_plain(shape,
                                                                  dtype)
    # the paper map from just before its windows open (t_start=5, step
    # ~5000) across its first loop exits (steps ~5449 on)
    omega_err["paper", "f32"] = check_omega_kernel_vs_plain(
        "paper", "f32", n_steps=751, start=4990)
    for (shape, dtype), (*_, runner) in omega_err.items():
        check(runner.form == "cluster", f"omega {shape} {dtype}: the "
              f"{runner.form} form, not the cluster form")
    print("omega kernel: vs plain with frames, 151 steps + the rest from "
          "parity 1, state, edges and frames bit for bit, dc-only av 0: " +
          ", ".join(f"{s} {d} {form_name(r)} av max abs err {e:.3e} "
                    f"(capture {c:.3e}, {n} exits)"
                    for (s, d), (e, c, n, r) in omega_err.items()) + " ok",
          flush=True)
    ok, os_, op_ms, osweep = omega_kernel_ms("omega16x4")
    ok_ms = sum(ok) / len(ok)
    oe_ms, _ = batched_engine_ms("omega16x4")
    per_step = 2 * (osweep.base.N + 1) * (osweep.base.M + 1) * osweep.B
    print(f"omega kernel time 16x4 N=40 M=500 f32, whole sweep "
          f"({osweep.n_steps} steps, CUDA events, in turns): cluster form "
          f"{', '.join(f'{v:.5f}' for v in ok)} ms/step, streaming form "
          f"{', '.join(f'{v:.5f}' for v in os_)} ms/step; plain version "
          f"{op_ms:.5f} ms/step, batched torch engine {oe_ms:.5f} ms/step; "
          f"cluster form {per_step / (ok_ms * 1e-3):.4e} site-updates/s "
          f"[{card}]", flush=True)
    pk, ps, pp_ms, psweep = omega_kernel_ms("paper")
    pk_ms, ps_ms = sum(pk) / len(pk), sum(ps) / len(ps)
    print(f"omega kernel time 16x16 paper map f32, whole sweep "
          f"({psweep.n_steps} steps, windows and exits included; CUDA "
          f"events, in turns): cluster form "
          f"{', '.join(f'{v:.5f}' for v in pk)} ms/step, streaming form "
          f"{', '.join(f'{v:.5f}' for v in ps)} ms/step; plain version "
          f"{pp_ms:.5f} ms/step [{card}]", flush=True)

    # 9. the omega sweep through the kernel against the batched engine
    omega_sweep_phase(card)

    # 10. the omega main path: the paper map, then the routing measurement
    omega_launches, omega_wall, omega_steps, paper = omega_main_phase(card)
    auto_wins = omega_routing_phase(card, omega_wall, omega_steps)
    print(f"omega routing: impl=auto takes omega sweeps to the per-omega "
          f"kernel; the kernel path is "
          f"{'faster' if auto_wins else 'NOT faster'} at both shapes "
          f"[{card}]", flush=True)

    # 11. frames-dir
    frames_phase(card)

    # 12. the stream kernel against its plain version and against B1
    stream_err = {}
    for name, shape, dtype in (
            ("N=100 M=12000", WIDE, "f32"), ("N=400 M=4000", TALL, "f32"),
            ("N=8 M=64", SMALL, "f64"),
            ("N=18 M=300", dict(n_harmonics=18, g_grid=300), "f64")):
        stream_err[name, dtype] = check_stream_vs_plain(shape, dtype)
    vs_b1 = {name: check_stream_vs_b1(shape) for name, shape in
             (("N=100 M=12000", WIDE), ("N=400 M=4000", TALL))}
    b2_plain_ms = stream_plain_ms(WIDE)
    b1_plain_ms = step_plain_ms(TALL)
    print("stream kernel: vs plain, K+3 steps then 5 from parity 1 with "
          "d77 records, state and edges bit for bit: " +
          ", ".join(f"{s} {d} av/records max abs err {e:.3e}"
                    for (s, d), e in stream_err.items()) +
          "; vs B1 over 203 steps f32, state and edges bit for bit: " +
          ", ".join(f"{s} av max abs err {e:.3e}" for s, e in vs_b1.items())
          + f" ok; plain versions {b2_plain_ms:.5f} ms/step at N=100 "
          f"M=12000 (B2), {b1_plain_ms:.5f} ms/step at N=400 M=4000 (B1) "
          f"[{card}]", flush=True)

    # 12, continued: B2's spill form against its plain version (B1's) at
    # its own shape and at small shapes through forced plans, and against
    # the tiling form and B1's per-half-step form
    spill_err = {}
    for name, shape, dtype, bands, R in SPILL_FORCED:
        err, runner = check_spill_vs_plain(shape, dtype, forced=(bands, R))
        spill_err[name, dtype] = err, runner.plan
    err, runner = check_spill_vs_plain(B2_OWN, "f32")
    spill_err["N=100 M=20000", "f32"] = err, runner.plan
    from slb2d_tpu_torch.ops import stepper_cuda
    check(runner.plan.S > 0
          and runner.plan.bands == stepper_cuda.card_sms(DEVICE),
          f"B2 spill at N=100 M=20000: plan {runner.plan}")
    forms_b2 = check_stream_forms(B2_OWN)
    spill_plain_ms = step_plain_ms(B2_OWN)
    print("spill kernel: B2's spill form vs plain (B1's run_chunk_plain), "
          "200 steps in 2 chunks with d77 records, state and edges bit for "
          "bit: " + ", ".join(
              f"{s} {d} ({p.bands} bands, R={p.R}, S={p.S}) av/records max "
              f"abs err {e:.3e}" for (s, d), (e, p) in spill_err.items())
          + f"; spill vs tiling vs B1 per-half-step over 203 steps at N=100 "
          f"M=20000 f32, state and edges bit for bit, av/records max abs err "
          f"{forms_b2:.3e} ok; plain version {spill_plain_ms:.5f} ms/step at "
          f"N=100 M=20000 [{card}]", flush=True)

    # 13. goldens through impl=stream (the tiling form, then the spill form
    # through forced plans of 2 and 3 bands); display 77 on both kernel
    # engines, and on the spill form
    golden_phase(card, impl="stream", form="tiling")
    d77_golden_phase(card)
    with forced_spill(2):
        golden_phase(card, impl="stream", form="spill")
        d77_golden_phase(card, impls=("stream",), form="spill")
    with forced_spill(3):
        golden_phase(card, impl="stream", form="spill")

    # 14. the stream main paths; 15. the routing measurement
    stream_runs = stream_main_phase(card)
    routing = stream_routing_phase(card)

    # B2 on the first shape past B1's residency (15, continued)
    b2_own, b2_model = b2_shape_phase(card)

    # 16. the lane-packed kernel: both forms against its plain version and
    # against each other, what each takes on the card, their times in turns
    lanes_err, lanes_form = {}, {}
    for shape, mp, n in LANES_SHAPES:
        for cs in (None, 0):
            err, runner = check_lanes_vs_plain(shape, mp, n, cluster_size=cs)
            check(runner.form == ("cluster" if cs is None else "streaming"),
                  f"lanes {shape} max_points={mp}: the {runner.form} form")
            lanes_err[shape, mp, runner.form] = err
            lanes_form[shape, mp, runner.form] = lanes_form_name(runner)
    for mp in (LANES_MAX_POINTS, SWEEP_POINTS):
        check_lanes_forms("full", mp)
    lanes_forms = lanes_forms_phase(card)
    at_once, sizes_ms = lanes_sizes_ms()
    fixed_ms = lanes_fixed_ms()
    print("lanes sizes: clusters at once by size: " +
          ", ".join(f"{cs}: {v}" for cs, v in at_once.items()) +
          "; whole 64-point sweep per step by blocks a point (CUDA events, "
          "in turns): " + "; ".join(
              f"max_points={mp} " + ", ".join(
                  f"CS={cs} " + "/".join(f"{v * 1e3:.3f}" for v in vs)
                  for cs, vs in t.items()) + " us"
              for mp, t in sizes_ms.items()) + "; fixed cost a step (16 "
          "points at N=6 M=29, one cell a thread): " + ", ".join(
              f"{'streaming' if cs == 0 else f'CS={cs}'} {v * 1e3:.3f} us"
              for cs, v in fixed_ms.items()) + f" [{card}]", flush=True)
    b4_k, b4_s, b4_plain_ms, b4_runner = lanes_kernel_ms()
    b4_k64, b4_s64, _, b4_runner64 = lanes_kernel_ms(SWEEP_POINTS, n_plain=5)
    b4_calls = lanes_call_ms()
    b4_ms, b4_stream_ms = sum(b4_k) / len(b4_k), sum(b4_s) / len(b4_s)
    print("lanes kernel: vs plain, split at step 151, state, per-lane rows "
          "and segment sums bit for bit: " + ", ".join(
              f"{s} max_points={mp} {lanes_form[s, mp, f]}"
              for (s, mp, f) in lanes_err) + "; cluster form vs streaming "
          f"form over the whole {SWEEP_POINTS}-point sweep at max_points="
          f"{LANES_MAX_POINTS} and {SWEEP_POINTS}, bit for bit ok; whole "
          f"sweep f32 (CUDA events, in turns): max_points="
          f"{LANES_MAX_POINTS} {lanes_form_name(b4_runner)} "
          f"{', '.join(f'{v:.5f}' for v in b4_k)} ms/step, streaming "
          f"{', '.join(f'{v:.5f}' for v in b4_s)}; one chunk of "
          f"{SWEEP_POINTS} {lanes_form_name(b4_runner64)} "
          f"{', '.join(f'{v:.5f}' for v in b4_k64)}, streaming "
          f"{', '.join(f'{v:.5f}' for v in b4_s64)}; plain version "
          f"{b4_plain_ms:.5f} ms/step; runner() wall (a fetch after each "
          f"chunk; host clock, in turns) "
          f"{', '.join(f'{v:.4f}' for v in b4_calls['runner'])} s, every "
          f"chunk enqueued before the first fetch "
          f"{', '.join(f'{v:.4f}' for v in b4_calls['overlapped'])} s "
          f"[{card}]", flush=True)

    # 17. the bench's sweep lanes mode; 18. every other bench mode
    b4_launches, b4_wall, b4_steps, lanes_sweep = lanes_main_phase(card)
    bench_modes_phase(card)

    # 19-21. the tests/perf probes: P1 (its rate is printed beside the data
    # sheet's under the bounds below), P2, P3
    p1, p1_launches, p1_plain_ms, p1_err, p1_sass, pipe = vpu_phase(
        card, lib.path)
    p1_rate = p1["rate"]
    p2, p2_launches, p2_plain_ms, p2_err = roll_phase(card)
    (p3, p3_launches, p3_plain_ms, p3_err, p3_model, p3_tc,
     p3_info) = transposed_phase(card)

    # 22. B3's cluster form against its streaming form over whole sweeps
    vs_stream = {shape: check_cluster_vs_streaming(shape)
                 for shape in ("full", "paper")}
    print("forms vs: B3 cluster form against its streaming form over the "
          "whole sweep, f32, state and edges (and frames) bit for bit: " +
          ", ".join(f"{s} {form_name(r)} av max abs err {e:.3e}"
                    + (f" capture {c:.3e}" if r.per_omega else "")
                    for s, (e, c, r) in vs_stream.items()) + f" ok [{card}]",
          flush=True)

    # 23. the streaming form, where no cluster holds a point, against its
    # plain version
    w_err, w_runner = check_sweep_kernel_vs_plain("wide8", "f32")
    ow_err, ow_cap, ow_exits, ow_runner = check_omega_kernel_vs_plain(
        "omega_wide8", "f32")
    check(w_runner.form == ow_runner.form == "streaming",
          f"8 points at N=100 M=4000 ran on the {w_runner.form} and "
          f"{ow_runner.form} forms")
    print(f"streaming: B3's streaming form past cluster residency, 8 points "
          f"at N=100 M=4000 f32 vs plain, state and edges bit for bit: "
          f"E_dc sweep 300 steps av max abs err {w_err:.3e}; omega sweep "
          f"to its end with frames av max abs err {ow_err:.3e} (capture "
          f"{ow_cap:.3e}, {ow_exits} exits) ok [{card}]", flush=True)

    # the bounds of each main path's run (B1: the tall grid, where impl=cuda
    # takes it; B2: the wide grid's impl=stream run, the same work as B1
    # there (its halo cells are overhead); sweep: the 64-point E_dc sweep;
    # paper: the paper map), at the data sheet's rate and at the rate P1
    # measured
    tall, tall_steps, (b1_launches, _), b1_tag = stream_runs[
        "N=400 M=4000", "impl=cuda"]
    check(b1_tag == "cuda-b1 resident", f"impl=cuda at N=400 M=4000 ran on "
          f"{b1_tag}, not on B1's resident form")
    wide, wide_steps, (_, b2_launches) = stream_runs["N=100 M=12000",
                                                     "stream tiling"]
    # B4: the same function as B3 shared-omega on the same sweep; its
    # per-lane accumulators are its design's overhead
    work = {
        "B1": (tall, tall_steps, main_path_flops(
            tall, tall_steps, av_steps=window_steps(tall, 10.0, tall_steps)),
            1),
        "B3 shared": (sweep.base, sweep_steps, main_path_flops(
            sweep.base, sweep_steps, points=sweep.B,
            av_steps=int(expected_av_counts(sweep).sum())), sweep.B),
        "B3 per-omega": (paper.base, omega_steps, main_path_flops(
            paper.base, omega_steps, points=paper.B,
            av_steps=int(expected_av_counts(paper).sum()),
            captures=paper.B, chains=True), paper.B),
        "B2": (wide, wide_steps, main_path_flops(
            wide, wide_steps, av_steps=window_steps(wide, 10.0, wide_steps)),
            1),
        "B2 spill": (b2_model, b2_own["steps"], main_path_flops(
            b2_model, b2_own["steps"], av_steps=window_steps(
                b2_model, 10.0, b2_own["steps"])), 1),
        "B4": (lanes_sweep.base, b4_steps, main_path_flops(
            lanes_sweep.base, b4_steps, points=lanes_sweep.B,
            av_steps=int(expected_av_counts(lanes_sweep).sum())),
            lanes_sweep.B)}
    bounds = {k: (bound_ms(m, n, f, points=b),
                  bound_ms(m, n, f, points=b, ops_rate=p1_rate))
              for k, (m, n, f, b) in work.items()}
    bounds.update(probe_bounds(p3_model, p3_tc, p1_rate))
    def mean(v):
        return sum(v) / len(v)

    b1_ms = mean(routing["N=400 M=4000"]["resident"])
    b1_per_ms = mean(routing["N=400 M=4000"]["per-half-step"])
    b2_ms = mean(routing["N=100 M=12000"]["stream"])
    b1_plan, b1_info = b1_forms["N=400 M=4000", "f32"]
    b2_spill_ms = mean(b2_own["ms_turns"]["spill"])
    times = {"B1": b1_ms, "B3 shared": sk_ms, "B3 per-omega": pk_ms,
             "B2": b2_ms, "B2 spill": b2_spill_ms, "B4": b4_ms}
    # B3's form on each main path, and what it takes on the card
    b3_form = {}
    for key, shape, per_omega in (("B3 shared", "full", False),
                                  ("B3 per-omega", "paper", True)):
        runner = vs_stream[shape][2]
        info = forms["N=40 M=500", "f32", per_omega, runner.cluster_size]
        b3_form[key] = dict(form=runner.form,
                            cluster_size=runner.cluster_size,
                            smem_bytes=info["smem_bytes"],
                            registers=info["registers"],
                            active_clusters=info["active_clusters"])

    # B4's form on its main path (the bench's chunks of 16)
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    b4_info = lanes_forms["full", LANES_MAX_POINTS][b4_runner.cluster_size]
    b4_form = dict(form=b4_runner.form, cluster_size=b4_runner.cluster_size,
                   a0_staged=slc.stages_a0(lanes_sweep.base.NHP,
                                           lanes_sweep.base.MP,
                                           b4_runner.cluster_size),
                   smem_bytes=b4_info["smem_bytes"],
                   registers=b4_info["registers"],
                   spills=b4_info["local_bytes"],
                   clusters_at_once=b4_info["active_clusters"])

    def shares(i):
        return ", ".join(f"{k} {bounds[k][i][0] / ms:.4f}"
                         for k, ms in times.items())

    print(f"bounds: operations per step " + ", ".join(
        f"{k} {f / n:.6e}" for k, (m, n, f, b) in work.items()) +
        f"; at the data sheet's {F32_OPS_PEAK:.4g} op/s (the bound): " +
        ", ".join(f"{k} {v[0][0] * 1e3:.4f} us ({v[0][1]})"
                  for k, v in bounds.items() if k in times) +
        f" per step, share {shares(0)}; at P1's measured mul+add rate "
        f"{p1_rate:.6e} op/s: " +
        ", ".join(f"{k} {v[1][0] * 1e3:.4f} us ({v[1][1]})"
                  for k, v in bounds.items() if k in times) +
        f", share {shares(1)}; probes: P1 {bounds['P1'][0][0] * 1e3:.4f} us "
        f"per turn ({bounds['P1'][0][1]}), P2 "
        f"{bounds['P2'][0][0] * 1e3:.4f} us per pass ({bounds['P2'][0][1]}), "
        f"P3 {bounds['P3'][0][0] * 1e3:.4f} us per step "
        f"({bounds['P3'][0][1]}); P1's FMA rate {2 * p1['fma_rate']:.6e} "
        f"flop/s [{card}]", flush=True)

    def entry(key, **kw):
        (ms, by), (ms_p1, _) = bounds[key]
        return {**kw, "bound_ms": ms, "bound_by": by,
                "bound_ms_at_p1_rate": ms_p1, "library_ms": None}

    from slb2d_tpu_torch.perf import vpu_roofline as vr
    p2t = {(r["kernel"], r["axis"], r["form"]): r["us_per_pass"] * 1e-3
           for r in p2["records"]}
    print(json.dumps({"kernels": [entry(
        "B1", name="slb_resident_chunk (resident_chunk<float>, one "
                   "cooperative launch per chunk); per-half-step form "
                   "slb_run_chunk (half_step<MAIN>, half_step<HALF>, "
                   "av_step)",
        route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=b1_launches,
        max_abs_err=max_err["N=400 M=4000", "f32", "resident"],
        ms=b1_ms, plain_ms=b1_plain_ms, form="resident", band=b1_plan.W,
        blocks=b1_plan.bands, threads=b1_plan.threads,
        smem_bytes=b1_plan.smem_bytes,
        static_smem_bytes=b1_info["static_smem_bytes"],
        registers=b1_info["registers"], spill_bytes=b1_info["local_bytes"],
        blocks_at_once=b1_info["blocks_at_once"],
        barrier_us=mean(barrier_res),
        barrier_us_per_half_step_form=mean(barrier_per),
        ms_per_half_step=b1_per_ms,
        ms_turns={k: v for k, v in routing["N=400 M=4000"].items()},
        sass=b1_sass_counts), entry(
        "B3 shared", name="slb_sweep_chunk (sweep_cluster<T, false>; "
                          "streaming form sweep_chunk<T, false>)",
        route="cuda", source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
        launches=sweep_launches, max_abs_err=sweep_err["full", "f32"][0],
        ms=sk_ms, plain_ms=sp_ms, ms_streaming=ss_ms,
        **b3_form["B3 shared"]), entry(
        "B3 per-omega", name="slb_sweep_chunk_omega (sweep_cluster<T, "
                             "true>; streaming form sweep_chunk<T, true>)",
        route="cuda", source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
        launches=omega_launches, max_abs_err=omega_err["paper", "f32"][0],
        capture_max_abs_err=omega_err["paper", "f32"][1],
        ms=pk_ms, plain_ms=pp_ms, ms_streaming=ps_ms,
        **b3_form["B3 per-omega"]), entry(
        "B2", name="slb_stream_chunk (stream_tile, stream_replay; B2's "
                   "tiling form)",
        route="cuda", source=STREAM_SOURCE, replaces=STREAM_REPLACES,
        launches=b2_launches, max_abs_err=stream_err["N=100 M=12000", "f32"],
        ms=b2_ms, plain_ms=b2_plain_ms, form="tiling"), entry(
        "B2 spill", name="slb_stream_spill_chunk (spill_chunk<float>, "
                         "B2's spill form, one cooperative launch per "
                         "chunk), at N=100 M=20000",
        route="cuda", source=STREAM_SOURCE, replaces=STREAM_REPLACES,
        launches=b2_own["launches"],
        max_abs_err=spill_err["N=100 M=20000", "f32"][0],
        ms=b2_spill_ms, plain_ms=spill_plain_ms, form="spill",
        own_shape=b2_own), entry(
        "B4", name="slb_lanes_cluster (lanes_cluster, one launch per "
                   "call); streaming form slb_lanes_chunk "
                   "(lanes_half_step<true>, lanes_half_step<false>)",
        route="cuda", source=LANES_SOURCE, replaces=LANES_REPLACES,
        launches=b4_launches,
        max_abs_err=lanes_err["full", LANES_MAX_POINTS, "cluster"],
        ms=b4_ms, plain_ms=b4_plain_ms, ms_streaming=b4_stream_ms,
        ms_one_chunk=sum(b4_k64) / len(b4_k64),
        ms_streaming_one_chunk=sum(b4_s64) / len(b4_s64),
        runner_wall_s=b4_calls, clusters_at_once_by_size=at_once,
        ms_by_cluster_size=sizes_ms, fixed_ms_per_step=fixed_ms,
        **b4_form), entry(
        "P1", name="slb_vpu_chain (vpu_chain<ILP, false>), per turn",
        route="cuda", source=VPU_SOURCE, replaces=VPU_REPLACES,
        launches=p1_launches, max_abs_err=p1_err,
        ms=p1["best"]["mul+add"]["ms"] / vr.REPS, plain_ms=p1_plain_ms,
        rate_op_s=p1_rate, pipe_rate_op_s=pipe, fma_per_s=p1["fma_rate"],
        chosen={k: {"ilp": v[0], "block": v[1]} for k, v in
                vr.CHOSEN.items()}, sass=p1_sass), entry(
        "P2", name="slb_roll_registers (roll_reg_halo<17,32> along axis "
                   "1, roll_reg_warp<13> along axis 0), per pass, form "
                   "two, axis 1",
        route="cuda", source=ROLL_SOURCE, replaces=ROLL_REPLACES,
        replaces_also=ROLL_REPLACES_ONE,
        launches=p2_launches["registers"], max_abs_err=p2_err["registers"],
        ms=p2t["registers", 1, "two"], plain_ms=p2_plain_ms,
        us_per_pass=p2["records"]), entry(
        "P2", name="slb_roll_passes (roll_pass), per pass, form two, axis 1",
        route="cuda", source=ROLL_SOURCE, replaces=ROLL_REPLACES,
        replaces_also=ROLL_REPLACES_ONE,
        launches=p2_launches["passes"], max_abs_err=p2_err["passes"],
        ms=p2t["passes", 1, "two"], plain_ms=p2_plain_ms), entry(
        "P3", name="slb_transposed_resident (t_resident_chunk, one "
                   "cooperative launch per chunk), per step",
        route="cuda", source=TRANSPOSED_SOURCE,
        replaces=TRANSPOSED_REPLACES, launches=p3_launches["resident"],
        max_abs_err=p3_err, ms=p3["us_per_step"] * 1e-3,
        plain_ms=p3_plain_ms, form="resident", plan=p3["plan"],
        b1_av_off_ms=p3["b1_us_per_step"] * 1e-3,
        us_turns=p3["us_turns"],
        registers=p3_info["resident"]["registers"],
        spill_bytes=p3_info["resident"]["local_bytes"],
        smem_bytes=p3_info["resident"]["smem_bytes"],
        blocks_at_once=p3_info["resident"]["blocks_at_once"]), entry(
        "P3", name="slb_transposed_chunk (t_half_step<true>, "
                   "t_half_step<false>, two launches per step), per step",
        route="cuda", source=TRANSPOSED_SOURCE,
        replaces=TRANSPOSED_REPLACES, launches=p3_launches["per-half-step"],
        max_abs_err=p3_err,
        ms=p3["us_per_step_per_half_step"] * 1e-3, plain_ms=p3_plain_ms,
        form="per-half-step",
        b1_av_off_ms=p3["b1_us_per_step_per_half_step"] * 1e-3,
        kernels=p3_info["per-half-step"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
