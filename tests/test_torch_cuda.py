"""The CUDA kernels on a card, against their plain PyTorch versions, and
the port's main paths there with their launch counts; the checks they
share are in tests/torch_support.py.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports neither jax nor the JAX package, so it also runs on a machine
without them (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import contextlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_support as ts
from slb2d_tpu_torch import bench, sweep_cli, tracing
from slb2d_tpu_torch.config import SimConfig, parse_cmd
from slb2d_tpu_torch.dryrun import dryrun_multichip
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import stencil, stepper_cuda
from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
from slb2d_tpu_torch.ops.frames import phi_x_grid
from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
from slb2d_tpu_torch.parallel.spatial import M_FIELDS
from slb2d_tpu_torch.perf import roll_cost_experiment as rce
from slb2d_tpu_torch.perf import transposed_experiment as te
from slb2d_tpu_torch.perf import vpu_roofline as vr
from slb2d_tpu_torch.runtime.loop import Simulation


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


# B1 in both forms at N=8 M=64 (200 steps), and its per-half-step form at
# BASELINE #4 (500 steps) and at the tall and the wide grid (200)
KERNEL_CASES = [("N8M64", dtype, form, 200) for dtype in ("f64", "f32")
                for form in ("resident", "per-half-step")] + [
    ("BASELINE4", "f64", "per-half-step", 500),
    ("BASELINE4", "f32", "per-half-step", 500),
    ("TALL", "f32", "per-half-step", 200),
    ("WIDE", "f32", "per-half-step", 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,form,n_steps", KERNEL_CASES)
def test_kernel_matches_plain(card, shape, dtype, form, n_steps):
    """n_steps in two chunks with display-77 records in a form of B1
    (state and edges bit for bit; av and records at f64 rtol 1e-12, f32
    rtol 1e-4 atol 1e-7)."""
    grid = {"N8M64": ts.SMALL}.get(shape) or getattr(ts, shape)
    _, runner = ts.check_kernel_vs_plain(grid, dtype, n_steps=n_steps,
                                         form=form)
    assert runner.form == form


@pytest.mark.cuda
def test_runner_validates_before_launch(card):
    cfg = SimConfig(display=4, t_start=0.05, **ts.PHYS,
                    **ts.SMALL)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, card)
    for form, per_run in (("resident", 1), ("per-half-step", 3 * 6)):
        runner = stepper_cuda.make_cuda_runner(c, model, form=form)
        state = stencil.bootstrap_state(c, model)
        bad = state.replace(a=state.a.t().contiguous().t())  # strided view
        with pytest.raises(ValueError, match="contiguous"):
            runner(bad, 4)
        with pytest.raises(ValueError, match="emit_idx"):
            runner.run_xs(state, {k: v for k, v in ts._setup(
                ts.SMALL, "f32", card)[2].items()}, 0,
                emit_idx=(5, 2))
        assert runner.launches == 0
        out = runner(state, 6)
        torch.cuda.synchronize()
        assert runner.launches == per_run and int(out.step) == 6
        assert out.a.data_ptr() == state.a.data_ptr()   # updated in place


# B1's resident form at N=8 M=64, BASELINE #4 (f32, f64), the wide grid,
# the tall grid and the displays' grids, BASELINE #1 and #3 (f32)
RESIDENT_CASES = [("N8M64", "f32", 200), ("N8M64", "f64", 200),
                  ("BASELINE4", "f32", 101), ("BASELINE4", "f64", 101),
                  ("WIDE", "f32", 41), ("TALL", "f32", 41),
                  ("BASELINE1", "f32", 500), ("BASELINE3", "f32", 500)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,n_steps", RESIDENT_CASES)
def test_resident_form_matches_plain(card, shape, dtype, n_steps):
    """The resident form against run_chunk_plain in two chunks (the
    second from parity 1) with display-77 records in both: state and
    edges bit for bit, av and records at ts.TOL; one launch a
    chunk."""
    grid = {"N8M64": ts.SMALL}.get(shape) or getattr(ts, shape)
    _, runner = ts.check_kernel_vs_plain(grid, dtype, n_steps=n_steps,
                                         form="resident")
    assert runner.form == "resident" and runner.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("grid", [(8, 300), (100, 4000)])
def test_resident_form_matches_per_half_step(card, dtype, grid):
    """B1's two forms over 203 steps from one state: state and edges bit
    for bit, av and records at the sums' order tolerance."""
    ts.check_resident_vs_per_half_step(
        dict(n_harmonics=grid[0], g_grid=grid[1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["TALL", "WIDE"])
def test_resident_form_matches_per_half_step_at_the_big_grids(card, grid):
    """The split-phase step over 203 steps at N=400 M=4000 (128 bands of
    32 columns, 408 rows) and N=100 M=12000 (bands of 96, the last 32) in
    f32, where f64 has no resident plan: bit for bit with the per-half-step
    form."""
    ts.check_resident_vs_per_half_step(getattr(ts, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_resident_form_in_short_chunks(card, dtype):
    """BASELINE #4 in chunks of 10 steps (the movie's), of 1 and of 45 (not
    a multiple of the table's 32-row stage), each with display-77 records
    (the first chunk's first step too, so the pre-step sums cross the grid
    barrier first): state and edges bit for bit with run_chunk_plain, av
    and records at ts.TOL, one launch a chunk."""
    model, c, xs = ts._setup(ts.BASELINE4, dtype, card)
    runner = stepper_cuda.make_cuda_runner(c, model, form="resident")
    kern = stencil.bootstrap_state(c, model)
    plain = kern.clone()
    done = 0
    for n in (10,) * 6 + (1, 45, 1, 10):
        part = {k: v[done:done + n] for k, v in xs.items()}
        emit = tuple(sorted({0, n // 2, n - 1}))
        kern = runner.run_xs(kern, part, done % 2, emit_idx=emit)
        plain, pobs = stepper_cuda.run_chunk_plain(
            c, plain, stepper_cuda.pack_xs_dict(part, model.np_dtype),
            done % 2, emit)
        torch.cuda.synchronize()
        done += n
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            assert torch.equal(getattr(kern, f), getattr(plain, f)), (n, f)
        torch.testing.assert_close(kern.av, plain.av, **ts.TOL[dtype])
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        torch.testing.assert_close(obs, pobs[:, :13].cpu(),
                                   **ts.TOL[dtype])
    assert bool(kern.av[0] > 0) and runner.launches == 10


@pytest.mark.cuda
def test_resident_form_counts_its_waits_only_while_spans_record(card,
                                                                monkeypatch):
    """Untraced, a chunk adds no counter and the runner copies nothing from
    the card (no Tensor.cpu, .numpy, .item or .tolist); while spans
    record, one copy of the tallies adds b1.waits = steps x bands and
    b1.waits_open <= b1.waits, and the next chunk starts from a reset
    counter."""
    model, c, xs = ts._setup(ts.BASELINE4, "f32", card)
    runner = stepper_cuda.make_cuda_runner(c, model, form="resident")
    state = stencil.bootstrap_state(c, model)
    copies = []
    for name in ("cpu", "numpy", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            copies.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    def waits():
        return {k: v for k, v in tracing.counters().items()
                if k.startswith("b1.")}
    before = waits()
    state = runner.run_xs(state, {k: v[:300] for k, v in xs.items()}, 0)
    torch.cuda.synchronize()
    assert copies == [] and waits() == before
    bands = runner.plan.bands
    for n in (300, 8):   # steps 300-599, then 600-607: parity 0 each
        w0 = tracing.counters().get("b1.waits", 0)
        o0 = tracing.counters().get("b1.waits_open", 0)
        with tracing.recording():
            state = runner.run_xs(state, {k: v[:n] for k, v in xs.items()},
                                  0)
        waits = tracing.counters()["b1.waits"] - w0
        opened = tracing.counters()["b1.waits_open"] - o0
        assert waits == n * bands and 0 <= opened <= waits, (n, waits,
                                                               opened)
    assert copies == ["cpu", "numpy"] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("W,why", [(512, "cudaError_t"),
                                   (32, "do not all fit")])
def test_refused_resident_launch_leaves_the_state_untouched(card, W, why):
    """A band the kernel cannot hold (W=512 at the tall grid: 3.4 MB a
    block) and more bands than the card runs at once (W=32 at the wide
    grid: 376 bands): the launch is refused before anything runs, the
    runner raises, and the state, av and every launch count stay as they
    were."""
    shape = ts.TALL if W == 512 else ts.WIDE
    model, c, _ = ts._setup(shape, "f32", card)
    runner = stepper_cuda.make_cuda_runner(c, model, form="resident")
    runner.plan = stepper_cuda.ResidentPlan(
        W, -(-model.MP // W), stepper_cuda.resident_smem_bytes(
            model.NHP, W, model.np_dtype), stepper_cuda.resident_threads(W))
    state = stencil.bootstrap_state(c, model)
    before = state.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match=why):
        runner(state, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_resident_form_info_at_the_shapes(card):
    """What the resident form takes at its plans: the shared memory the
    plan computed, at most 64 registers a thread (1024 threads a block),
    and every band's block on the card at once."""
    for NHP, MP, D in ((408, 4096, np.float32), (104, 12032, np.float32),
                       (104, 4096, np.float32), (104, 4096, np.float64)):
        plan = stepper_cuda.resident_plan(NHP, MP, D,
                                          stepper_cuda.card_sms(card))
        info = stepper_cuda.form_info(D, plan.W, NHP, MP)
        assert info["smem_bytes"] == plan.smem_bytes
        assert info["threads"] == plan.threads
        assert 0 < info["registers"] <= 64
        assert info["blocks_at_once"] >= plan.bands


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,n_steps", [("ragged", 60), ("full", 300)])
def test_sweep_kernel_matches_plain(card, shape, n_steps, dtype):
    """The sweep kernel on the ragged 6-point grid (a dc-only point, mu
    swept), 60 steps, and on the 64-point E_dc sweep at N=40 M=500 (on
    the cluster form its plan picks), 300 steps, in two chunks (f64 rtol
    1e-12, f32 rtol 1e-4 atol 1e-7, edges bit for bit, the dc-only
    point's av exactly 0)."""
    _, runner = ts.check_sweep_kernel_vs_plain(shape, dtype, n_steps=n_steps)
    assert shape != "full" or runner.form == "cluster"


@pytest.mark.cuda
def test_sweep_runner_validates_before_launch(card):
    sweep, runner = ts._sweep_setup("ragged", "f32")
    state = sweep._initial_states()
    bad = state.replace(av=state.av.t().contiguous().t())   # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(bad, 4)
    assert runner.launches == 0
    out = runner.advance(state, 6)
    torch.cuda.synchronize()
    assert runner.launches == 1 and int(out.step[0]) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,start", [
    ("omega_ragged", "f64", 0), ("omega_ragged", "f32", 0),
    ("omega16x4", "f64", 0), ("omega16x4", "f32", 0), ("paper", "f32", 4990)])
def test_omega_kernel_matches_plain(card, shape, dtype, start):
    """The per-omega sweep kernel, 151 steps then the rest from parity 1
    (f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7 on states, av, the loop-exit
    captures and the frames arrays; edges bit for bit): on the ragged
    5-point omega grid (a dc-only point, distinct windows, the dc-only
    point's av exactly 0) and on 16 omegas x 4 E_dc, each run to its end,
    and on the 16 x 16 paper map from step 4990 across its window start
    and first loop exits (751 steps); the two maps on the cluster form."""
    *_, runner = ts.check_omega_kernel_vs_plain(
        shape, dtype, n_steps=751 if start else None, start=start)
    assert shape == "omega_ragged" or runner.form == "cluster"


@pytest.mark.cuda
def test_omega_runner_validates_before_launch(card):
    sweep, runner = ts._sweep_setup("omega_ragged", "f32")
    assert runner.per_omega
    state = sweep._initial_states()
    cap = ts._zero_cap(sweep)
    bad = state.replace(b=state.b.transpose(1, 2).contiguous()
                        .transpose(1, 2))                # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(bad, 4, cap=cap)
    assert runner.launches == 0
    out, cap = runner.advance(state, 6, cap=cap)
    torch.cuda.synchronize()
    assert runner.launches == 1 and int(out.step[0]) == 6
    assert set(cap) == {"v_dr", "v_y", "m_x", "norm"}
    frames = ts._zero_cap(sweep, frames=True)
    del frames["b"]
    with pytest.raises(ValueError, match="both a and b"):
        runner.advance(out, 4, cap=frames)
    assert runner.launches == 1


def _cluster_cases():
    """(mode, dtype, shape, cluster size) for every cluster size that holds
    a point of the ragged grids (NHP=16, MP=128) and of their N=40 M=500
    versions (NHP=48, MP=512): pure arithmetic on the shapes, the same in
    every process."""
    cases = []
    for mode in ("shared", "omega"):
        for dtype, D in (("f64", np.float64), ("f32", np.float32)):
            for shape, NHP, MP in (("ragged", 16, 128), ("ragged40", 48, 512)):
                for cs in ssc.CLUSTER_SIZES:
                    if ssc.cluster_smem_bytes(NHP, MP, D, cs) is not None:
                        cases.append((mode, dtype, shape, cs))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype,shape,cluster_size", _cluster_cases())
def test_sweep_cluster_form_matches_plain(card, mode, dtype, shape,
                                          cluster_size):
    """B3's cluster form at every cluster size that holds the point,
    against the plain version: the shared mode 60 steps in two chunks, the
    per-omega mode over the whole sweep with frames (151 steps, then the
    rest from parity 1); state, edges and frames bit for bit, av and
    captures at f64 rtol 1e-12 / f32 rtol 1e-4 atol 1e-7, the dc-only
    point's av exactly 0."""
    if mode == "shared":
        _, runner = ts.check_sweep_kernel_vs_plain(
            shape, dtype, n_steps=60, cluster_size=cluster_size)
    else:
        *_, runner = ts.check_omega_kernel_vs_plain(
            "omega_" + shape, dtype, cluster_size=cluster_size)
    assert runner.form == "cluster" and runner.cluster_size == cluster_size
    assert runner.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sweep_streaming_form_matches_plain(card, dtype):
    """The streaming form, forced where a cluster would hold the point,
    passes the checks it passed as the only form: both modes on the ragged
    grids, state and edges bit for bit."""
    _, runner = ts.check_sweep_kernel_vs_plain(
        "ragged", dtype, n_steps=60, cluster_size=0)
    *_, o_runner = ts.check_omega_kernel_vs_plain(
        "omega_ragged", dtype, cluster_size=0)
    assert runner.form == o_runner.form == "streaming"
    assert runner.cluster_size == o_runner.cluster_size == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged40", "omega_ragged40"])
def test_refused_cluster_launch_raises_before_any_state_changes(card,
                                                                 shape):
    """A cluster too small for the point: the runner refuses it at
    construction, and the kernel refuses the launch if it is asked for
    anyway; the state, the capture and every launch count stay as they
    were."""
    sweep, runner = ts._sweep_setup(shape, "f32")
    assert runner.form == "cluster" and runner.cluster_size == 2
    with pytest.raises(ValueError, match="cannot hold"):
        ssc.SweepStackRunner(sweep, cluster_size=1)
    runner.cluster_size = 1           # 393 KB a block: past any block
    state = sweep._initial_states()
    before = state.clone()
    cap = ts._zero_cap(sweep, frames=True) if runner.per_omega \
        else None
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        if cap is None:
            runner.advance(state, 8)
        else:
            runner.advance(state, 8, cap=cap)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert all(bool((v == 0).all()) for v in (cap or {}).values())
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_form_info_at_the_sweep_shape(card):
    """What the plan's forms take at N=40 M=500: the shared memory the
    plan computed, at most 64 registers a thread (1024 threads a block),
    and at least one cluster on the card."""
    for D in (np.float32, np.float64):
        cs, smem = ssc.cluster_plan(48, 512, D)
        for per_omega in (False, True):
            info = ssc.form_info(D, per_omega, cs, 48, 512)
            assert info["smem_bytes"] == smem
            assert 0 < info["registers"] <= 64
            assert info["active_clusters"] >= 1
            stream = ssc.form_info(D, per_omega, 0, 48, 512)
            assert stream["smem_bytes"] == 0 and stream["active_clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("grid,dtype", [
    ((8, 64), "f64"), ((8, 64), "f32"), ((18, 300), "f64"),
    ((18, 300), "f32"), ("WIDE", "f32"), ("TALL", "f32")])
def test_stream_kernel_matches_plain(card, grid, dtype):
    """The temporal-tiling kernel against its plain version, K+3 steps
    then 5 from parity 1 with display-77 records (state and edges bit for
    bit; av and records at f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7), at
    small grids and at the wide and the tall grid."""
    ts.check_stream_vs_plain(
        getattr(ts, grid) if isinstance(grid, str)
        else dict(n_harmonics=grid[0], g_grid=grid[1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,dtype", [
    ((8, 300), "f64"), ((8, 300), "f32"), ("WIDE", "f32"), ("TALL", "f32")])
def test_stream_kernel_matches_step_kernel(card, grid, dtype):
    """B2 and B1 from one state over 203 steps at N=8 M=300 and at the
    wide and the tall grid: state and edges bit for bit, av and records
    at the sums' order tolerance."""
    ts.check_stream_vs_b1(
        getattr(ts, grid) if isinstance(grid, str)
        else dict(n_harmonics=grid[0], g_grid=grid[1]), dtype)


@pytest.mark.cuda
def test_stream_runner_validates_before_launch(card):
    model, c, xs, runner = ts._stream_runner(ts.SMALL, "f32")
    state = stencil.bootstrap_state(c, model)
    bad = state.replace(b=state.b.t().contiguous().t())   # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner(bad, 4)
    with pytest.raises(ValueError, match="emit_idx"):
        runner.run_xs(state, xs, 0, emit_idx=(5, 2))
    assert runner.launches == 0
    out = runner(state, 11)
    torch.cuda.synchronize()
    assert runner.launches == 2 * -(-11 // runner.geom.K)
    assert int(out.step) == 11
    assert out.a.data_ptr() == state.a.data_ptr()   # updated in place


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4))
def test_spill_form_matches_plain(card, case):
    """B2's spill form through forced plans (2 and 5 bands, every band
    spilling; M+1 in a slab at N=13 M=300) against its plain version,
    B1's run_chunk_plain, in two chunks with display-77 records (state
    and edges bit for bit, av and records at ts.TOL; one launch a
    chunk)."""
    name, shape, dtype, bands, R = ts.SPILL_FORCED[case]
    _, runner = ts.check_spill_vs_plain(
        shape, dtype, forced=(bands, R))
    assert runner.form == "spill" and runner.launches == 2
    assert (runner.plan.bands, runner.plan.R) == (bands, R)


@pytest.mark.cuda
def test_spill_form_at_its_own_shape(card):
    """N=100 M=20000 f32, where impl=cuda runs the spill form: against
    run_chunk_plain over 61 steps in two chunks (the averaging window
    opens at step 50), and against the tiling
    form and B1's per-half-step form over 203 steps, state bit for bit."""
    _, runner = ts.check_spill_vs_plain(ts.B2_OWN, "f32", n_steps=61)
    assert runner.plan.R == 128 and runner.plan.S == 25
    assert runner.plan.bands == stepper_cuda.card_sms(card)
    ts.check_stream_forms(ts.B2_OWN)


@pytest.mark.cuda
def test_spill_form_tallies_its_grid_barrier_only_while_spans_record(card):
    """N=100 M=20000 f32 (the wide.d4 cell's grid): a spill-form chunk of
    200 steps outside tracing.recording() adds no b2.* counter; the same
    chunk inside it adds 0 < b2.sync_cycles < b2.band_cycles, each band's
    tally too; both chunks' states and edges bit for bit with the plain
    version's."""
    model, c, xs, runner = ts._stream_runner(ts.B2_OWN, "f32",
                                             form="spill")
    win = {k: v[:200] for k, v in xs.items()}
    state0 = stencil.bootstrap_state(c, model)
    plain, _ = stepper_cuda.run_chunk_plain(
        c, state0.clone(), stepper_cuda.pack_xs_dict(win, model.np_dtype), 0)

    def b2():
        return {k: v for k, v in tracing.counters().items()
                if k.startswith("b2.")}
    before = b2()
    untraced = runner.run_xs(state0.clone(), win, 0)
    torch.cuda.synchronize()
    assert b2() == before
    with tracing.recording():
        traced = runner.run_xs(state0.clone(), win, 0)
    band = b2()["b2.band_cycles"] - before.get("b2.band_cycles", 0)
    sync = b2()["b2.sync_cycles"] - before.get("b2.sync_cycles", 0)
    assert 0 < sync < band, (sync, band)
    tally = runner._bufs[3].cpu()
    assert bool((tally[1::2] > 0).all() and (tally[1::2] < tally[0::2]).all())
    assert int(tally[0::2].sum()) == band and int(tally[1::2].sum()) == sync
    for out in (untraced, traced):
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            assert torch.equal(getattr(out, f), getattr(plain, f)), f
    assert runner.launches == 2


@pytest.mark.cuda
def test_refused_spill_launch_leaves_the_state_untouched(card):
    """More bands than the card runs at once (a forced plan of 400 bands
    at N=100 M=20000): the launch is refused before anything runs, the
    runner raises, and the state, av and every launch count stay as they
    were."""
    model, c, _ = ts._setup(ts.B2_OWN, "f32", card)
    plan = sst.spill_plan(model.NHP, model.MP, model.np_dtype, sms=400,
                          R=32)
    assert plan is not None
    runner = sst.make_stream_runner(c, model, form="spill", spill=plan)
    state = stencil.bootstrap_state(c, model)
    before = state.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="do not all fit"):
        runner(state, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_spill_form_info_at_its_shape(card):
    """What the spill form takes at its plan: the shared memory the plan
    computed, at most 64 registers a thread (1024 threads a block), every
    band's block on the card at once."""
    plan = sst.spill_plan(104, 20096, np.float32,
                          stepper_cuda.card_sms(card))
    info = sst.spill_form_info(np.float32, plan, 104, 20096)
    assert info["smem_bytes"] == plan.smem_bytes
    assert info["threads"] == plan.threads == 1024
    assert 0 < info["registers"] <= 64
    assert info["blocks_at_once"] >= plan.bands


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size", [None, 0])
@pytest.mark.parametrize("shape,max_points,n_steps", [
    ("lanes3", 16, None), ("omega_ragged", 2, None),
    ("omega_ragged", 16, None), ("full", 16, 300), ("full", 64, 300)])
def test_lanes_kernel_matches_plain(card, shape, max_points, n_steps,
                                    cluster_size):
    """The lane-packed kernel in the form the plan picks (the cluster form
    at every one of these shapes) and in the streaming form against its
    plain version, split across calls at step 151 (the second call from
    parity 1): state,
    per-lane rows and segment sums bit for bit; av counts equal to the
    schedule and every capture fired where run to the end; the dc-only
    point's av exactly 0.  max_points=2 pads the ragged grid's last chunk
    with a dead lane; the 64-point sweep runs 300 steps in chunks of 16
    and in one of 64."""
    runner = ts.check_lanes_vs_plain(shape, max_points, n_steps,
                                     cluster_size=cluster_size)
    assert runner.form == ("cluster" if cluster_size is None
                           else "streaming")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_points", [("full", 16), ("full", 64),
                                              ("omega_ragged", 2)])
def test_lanes_cluster_form_matches_streaming_form(card, shape,
                                                   max_points):
    """The cluster form against the streaming form over the whole sweep
    from each chunk's bootstrap, one call per chunk: state, per-lane rows
    and segment sums bit for bit."""
    runner = ts.check_lanes_forms(shape, max_points)
    assert runner.launches == len(runner.packs)


@pytest.mark.cuda
def test_forced_lanes_cluster_past_residency_raises_before_any_launch(card):
    """8 points at N=100 M=4000 (6.8 MB a point): the plan gives the
    streaming form, a forced cluster size is refused at construction,
    and a cluster form forced onto the runner anyway is refused by the
    kernel before launching; the state and every launch count stay as
    they were."""
    sweep, runner = ts._lanes_runner("wide8")
    assert runner.form == "streaming" and runner.cluster_size == 0
    for cs in slc.CLUSTER_SIZES:
        with pytest.raises(ValueError, match="cannot hold"):
            slc.make_sweep_lanes_runner(sweep, cluster_size=cs)
    runner.form, runner.cluster_size = "cluster", 8
    st = runner.start(0)
    before = st.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        runner.advance(0, st, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
        assert torch.equal(getattr(st, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_lanes_form_info_at_the_sweep_shape(card):
    """What the plan's forms take at N=40 M=500 in chunks of 16 and of 64,
    the plan made with the card's own clusters at once: the shared memory
    the plan computed, at most 64 registers a thread (1024 threads a
    block), and the whole chunk at once (one wave)."""
    for CB in (16, 64):
        cs, smem = slc.lanes_cluster_plan(
            48, 512, CB,
            lambda c: slc.form_info(c, 48, 512, CB)["active_clusters"])
        info = slc.form_info(cs, 48, 512, CB)
        assert info["smem_bytes"] == smem
        assert 0 < info["registers"] <= 64
        assert info["active_clusters"] >= CB
        stream = slc.form_info(0, 48, 512, CB)
        assert stream["smem_bytes"] == 0 and stream["active_clusters"] > 0


@pytest.mark.cuda
def test_lanes_runner_validates_before_launch(card):
    """Bad tensors are refused before any launch; a call of 6 steps is one
    launch of the cluster form, in place."""
    sweep, runner = ts._lanes_runner("lanes3")
    assert runner.form == "cluster" and runner.cluster_size == 4
    st = runner.start(0)
    bad = st.__class__(**{**vars(st), "cap": st.cap.t().contiguous().t()})
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(0, bad, 4)
    assert runner.launches == 0
    out = runner.advance(0, st, 6)
    torch.cuda.synchronize()
    assert runner.launches == 1 and out.a.data_ptr() == st.a.data_ptr()
    assert bool(torch.all(out.av[0, :sweep.base.MP] == 0))   # t < t_start


@pytest.mark.cuda
@pytest.mark.parametrize("fma", [False, True])
def test_vpu_kernel_matches_plain(card, fma):
    """P1's chain kernel against its plain version, 2 turns at a ragged
    13 x 1000 cut of the probe's input (the tail masked) and at its full
    shape: bit for bit at every ILP, at two block sizes."""
    for shape in ((13, 1000), (vr.NHP, vr.MP)):
        coef, bias, x = vr.make_coeffs(shape)
        xt = torch.from_numpy(x).to(card)
        ref = vr.chain_plain(xt, coef, bias, 2, fma)
        for ilp in vr.ILPS:
            for block in (64, 256):
                got = vr.chain(xt, coef, bias, 2, fma=fma, ilp=ilp,
                               block=block)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (shape, ilp, block)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_roll_kernels_match_plain(card, axis):
    """P2's register and per-pass kernels against the plain version, 5
    and 100 passes (three halo refreshes at T=32), forms two and one, at
    the probe's shape and at 8 x 128: bit for bit; the inputs unchanged."""
    for shape in ((8, 128), (rce.NH, rce.MP)):
        x, y = (torch.from_numpy(a).to(card) for a in rce.make_inputs(shape))
        x0 = x.clone()
        for arrays in ([x, y], [torch.cat([x, y], 0)]):
            for k in (5, 100):
                ref = rce.roll_plain(arrays, axis, k)
                for fn in (rce.roll_registers, rce.roll_passes):
                    got = fn(arrays, axis, k)
                    torch.cuda.synchronize()
                    assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert torch.equal(x, x0)


@pytest.mark.cuda
@pytest.mark.parametrize("every", [None, 7, 1])
def test_register_halo_forms_match_plain(card, every):
    """roll_reg_halo along both axes of lines of 1024 and 2048, the halo
    refreshed every T passes, every 7 and every pass, 70 passes: bit for
    bit with the plain version."""
    x, y = (torch.from_numpy(a).to(card) for a in rce.make_inputs((4, 1024)))
    for axis, arrays in ((1, [x, y]), (0, [x.t().contiguous()]),
                         (1, [torch.cat([x, y], 1)])):
        ref = rce.roll_plain(arrays, axis, 70)
        got = rce.roll_registers(arrays, axis, 70, every=every)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), axis


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["resident", "per-half-step"])
@pytest.mark.parametrize("nhl", [16, 32])
def test_transposed_kernel_matches_b1_plain(card, nhl, form):
    """P3's kernel in each form against its plain version, B1's plain
    version (av off) transposed, 41 steps in two chunks (the second from
    parity 1), N=8 M=64: the state, transposed back, bit for bit; padding
    columns stay 0; one launch a chunk on the resident form, two a step on
    the other."""
    model, c, tc, state0, xs = te.setup(card, 8, 64, nhl, 41)
    kern, plain = te.transpose_state(state0, nhl), te.transpose_state(
        state0, nhl)
    launches0 = te.launch_count
    for part, parity in ((xs[:21], 0), (xs[21:], 1)):
        kern = te.run_chunk(tc, kern, part, parity, form=form)
        plain = te.run_chunk_plain(tc, plain, part, parity)
    torch.cuda.synchronize()
    assert te.launch_count - launches0 == (2 if form == "resident"
                                           else 2 * 41)
    got, mine = (te.untranspose(s, model.NHP) for s in (kern, plain))
    for f, v in got.items():
        assert torch.equal(v, mine[f]), f
    assert bool((kern.a[:, model.NHP:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [None, 5])
def test_transposed_resident_form_matches_per_half_step(card, sms):
    """P3's resident form (its plan, and 5 bands of 26 rows) against its
    per-half-step form over 61 steps in two chunks at N=13 M=300 NHL=32:
    bit for bit."""
    model, c, tc, state0, xs = te.setup(card, 13, 300, 32, 61)
    plan = (None if sms is None else
            te.resident_plan(model.NHP, model.MP, 32, sms))
    res, per = te.transpose_state(state0, 32), te.transpose_state(state0, 32)
    for part, parity in ((xs[:31], 0), (xs[31:], 1)):
        res = te.run_chunk(tc, res, part, parity, plan=plan)
        per = te.run_chunk(tc, per, part, parity, form="per-half-step")
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(res, f), getattr(per, f)), f


@pytest.mark.cuda
def test_transposed_resident_form_at_baseline4(card):
    """P3's resident form at BASELINE #4 (128 bands of 32 rows) against its
    plain version over 41 steps in two chunks: bit for bit; what it takes
    on the card holds the plan."""
    model, c, tc, state0, xs = te.setup(card, steps=41)
    plan = te.resident_plan(model.NHP, model.MP, te.NHL, te.card_sms(card))
    kern, plain = te.transpose_state(state0), te.transpose_state(state0)
    for part, parity in ((xs[:21], 0), (xs[21:], 1)):
        kern = te.run_chunk(tc, kern, part, parity)
        plain = te.run_chunk_plain(tc, plain, part, parity)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    info = te.form_info(plan, model.NHP, model.MP)["resident"]
    assert info["smem_bytes"] == plan.smem_bytes
    assert info["threads"] == plan.threads
    assert info["blocks_at_once"] >= plan.bands and info["local_bytes"] == 0


@pytest.mark.cuda
def test_probe_wrappers_validate_before_launch(card):
    coef, bias, x = vr.make_coeffs((4, 128))
    xt = torch.from_numpy(x).to(card)
    counts = (vr.launch_count, rce.register_launch_count,
              rce.pass_launch_count, te.launch_count)
    with pytest.raises(ValueError, match="float32"):
        vr.chain(xt.double(), coef, bias, 1)
    with pytest.raises(ValueError, match="ilp"):
        vr.chain(xt, coef, bias, 1, ilp=3)
    with pytest.raises(ValueError, match="lines of 100"):
        rce.roll_registers([torch.zeros((100, 8), device=card)], 0, 2)
    with pytest.raises(ValueError, match="every=40"):
        rce.roll_registers([torch.zeros((8, 1024), device=card)], 1, 2,
                           every=40)
    model, c, tc, state0, xs = te.setup(card, 8, 64, 16, 4)
    st = te.transpose_state(state0, 16)
    bad = te.TState(**{**vars(st), "b": st.b.t().contiguous().t()})
    for form in te.FORMS:
        with pytest.raises(ValueError, match="contiguous"):
            te.run_chunk(tc, bad, xs, 0, form=form)
    with pytest.raises(ValueError, match="form must be"):
        te.run_chunk(tc, st, xs, 0, form="banded")
    assert counts == (vr.launch_count, rce.register_launch_count,
                      rce.pass_launch_count, te.launch_count)


@pytest.mark.cuda
def test_refused_transposed_resident_launch_raises(card):
    """A plan the kernel cannot hold (rows past MAX_ROWS) and more bands
    than the card runs at once (2 rows a band at MP=4096: 2048 blocks of
    1024 threads at NHL=512): the launch is refused before anything runs,
    run_chunk raises, and the state and the launch counts stay as they
    were."""
    nhl = 512
    model, c, tc, state0, xs = te.setup(card, 8, 4000, nhl, 4)
    st = te.transpose_state(state0, nhl)
    before = st.clone()
    counts = (te.launch_count, te.resident_launch_count)
    for R, why in ((514, "cudaError_t"), (2, "at once")):
        plan = te.TPlan(R, -(-model.MP // R),
                        te.resident_smem_bytes(nhl, R),
                        te.resident_threads(nhl, R))
        with pytest.raises(RuntimeError, match=why):
            te.run_chunk(tc, st, xs, 0, plan=plan)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(st, f), getattr(before, f)), f
    assert counts == (te.launch_count, te.resident_launch_count)


# the single-run driver's kernel engines in every form: (impl, the form
# ts.forced_form gives it; None is the plans' own choice)
DRIVER_FORMS = [("cuda", None), ("cuda", "per-half-step"),
                ("stream", None), ("stream", "spill")]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,form", DRIVER_FORMS)
def test_display_and_repl_goldens(card, tmp_path, impl, form):
    """Displays 3, 4, 7 and 77 (d3_tiny_*, d4_base1_*, d7_frame*,
    d77_tiny_*_fixed) and the three recorded parameter-server sessions on
    each form, at tests/test_golden.py's tolerances with the headers byte
    for byte; the form is checked to be the one that ran."""
    errs = ts.displays_golden(impl, form, str(tmp_path))
    assert len(errs) == 13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_device_frame_matches_host_frame(card, dtype):
    """The device frame (in the state's dtype) against the host f64 frame
    of the same state at BASELINE #3's grid: f32 at the D7 envelope (rtol
    2e-4, atol 3e-6), f64 at rtol 1e-12 atol 1e-14."""
    err, shape = ts.device_frame_vs_host(dtype, n_steps=300)
    assert shape == (629, 1001) and err < (3e-6 if dtype == "f32"
                                           else 1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(("cuda", None), ("cuda", "per-half-step")),
                                  (("stream", None), ("stream", "spill"))])
@pytest.mark.parametrize("display", [4, 9])
def test_mutations_and_resume_reach_every_form(card, tmp_path, pair,
                                               display):
    """A parameter-server session (display 4) or a display-9 run resumed
    from a checkpoint at an odd step on two forms: the states bit for bit
    (av at ts.TOL), the strobe files byte for byte."""
    kw = dict(n_harmonics=8, g_grid=64, dtype="f32",
              **{**ts.PHYS, "omega": 50.0})
    out = []
    for impl, form in pair:
        d = str(tmp_path / f"{impl}-{form}")
        with ts.forced_form(form), ts.in_dir(d):
            if display == 4:
                sim = ts.run_sim(
                    dict(display=4, t_start=0.1, read_from="stdin", **kw),
                    impl, repl="E_dc 1.5 0.05\nomega 60 0.03\nexit\n")
            else:
                cfg = dict(display=9, t_start=0.05, **kw)
                from slb2d_tpu_torch.config import SimConfig
                from slb2d_tpu_torch.runtime.loop import Simulation
                first = Simulation(SimConfig(impl=impl, quiet=True,
                                             out_file="o.txt",
                                             checkpoint="ck.npz", **cfg),
                                   device=card)
                first.t_max = 0.4005
                first.run()
                assert first.steps_done % 2 == 1
                sim = ts.run_sim(dict(cfg, resume="ck.npz"), impl)
        assert (sim.engine_tag().split()[1] ==
                (form or ("resident" if impl == "cuda" else "tiling")))
        files = {f.name: f.read_bytes()
                 for f in (tmp_path / f"{impl}-{form}").iterdir()
                 if f.name.startswith("strobe")}
        out.append((sim, files))
    ts._state_equal(out[0][0].state, out[1][0].state,
                            f"{pair} display {display}")
    assert out[0][1] == out[1][1]
    assert len(out[0][1]) == (101 if display == 9 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dtype,grid", [("f64", (8, 64)), ("f32", (8, 64)),
                                        ("f32", (18, 300)), ("f64", (18, 300)),
                                        ("f32", (100, 12000)),
                                        ("f32", (100, 20000))])
def test_sharded_stream_matches_plain(card, dtype, grid, S):
    """B2's sharded form on S slots of cuda:0 against its plain version,
    K+3 steps then 5 from parity 1 with display-77 records (state and
    edges bit for bit, av and records at ts.TOL; S + 1 launches a
    round)."""
    _, runner = ts.check_shard_vs_plain(
        dict(n_harmonics=grid[0], g_grid=grid[1]), dtype, S)
    assert runner.form == "sharded" and runner.layout.S == S


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged", "omega_ragged", "full"])
def test_sweep_mesh_on_two_slots_matches_one(card, shape):
    """A "sweep" mesh of two slots of cuda:0 (B3 a block) against the
    same sweep on the card alone: the table and the frames bit for bit,
    each block launching what the sweep alone did."""
    kw, params = ts.sweep_grid(shape)
    cfg = SimConfig(display=4, dtype="f32", impl="cuda", quiet=True, **kw)
    one = ParameterSweep(cfg, params, device=card, capture_state=True)
    ref, got = ts.counted(one.run)
    two = ParameterSweep(cfg, params, capture_state=True,
                         mesh=make_mesh((2,), ("sweep",),
                                        devices=[card] * 2))
    assert two.engine == "cuda"
    res, got2 = ts.counted(two.run)
    b3 = got["B3"] + got["B3 per-omega"]
    assert b3 > 0 and got2["B3"] + got2["B3 per-omega"] == 2 * b3
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    for got, want in zip(two.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_dryrun_on_four_slots_of_the_card(card):
    """dryrun_multichip(4) on four slots of cuda:0: its six checks pass
    and B2's sharded form and both modes of B3 launch."""
    out = dryrun_multichip(4, device=card)
    assert out["mesh"] == (2, 2)
    assert out["launches"] == {"b2_sharded_tiles": 6,
                               "b2_sharded_replays": 3, "b3_shared": 2,
                               "b3_omega": 2}


@pytest.mark.cuda
def test_combined_sweep_on_slots_of_the_card(card):
    """The combined layout on a (2, 2) mesh of cuda:0 (a ragged grid with
    frames) against the batched engine on the card alone: the captured
    state bit for bit, the table at the sums' order."""
    kw, params = ts.sweep_grid("ragged")
    cfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True, **kw)
    one = ParameterSweep(cfg, params, device=card, capture_state=True)
    ref = one.run()
    comb = ParameterSweep(cfg, params, capture_state=True,
                          mesh=make_mesh((2, 2), ("sweep", "space"),
                                         devices=[card] * 4),
                          space_axis="space")
    res = comb.run()
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=2e-6,
                                   err_msg=k)
    for got, want in zip(comb.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)


# ---- the main shapes and the CLIs' runs -----------------------------------

# the CLI at BASELINE #4's physics (t-max=10, f32): the engine and form
# impl=cuda takes at each shape, and its runs (display, impl, B1's form
# forced or None)
CLI_RUNS = {
    "BASELINE4": (("cuda-b1", "resident"),
                  [(4, "cuda", None), (77, "cuda", None)]),
    "WIDE": (("cuda-b1", "resident"),
             [(4, "stream", None), (4, "cuda", None), (77, "stream", None)]),
    "TALL": (("cuda-b1", "resident"),
             [(4, "stream", None), (4, "cuda", None),
              (4, "cuda", "per-half-step"), (77, "stream", None)]),
    "B2_OWN": (("stream", "spill"), [(4, "cuda", None)])}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CLI_RUNS))
def test_cli_main_paths(card, shape):
    """cli.main at each shape: the launches per engine and form (B1
    resident and B2 spill one a chunk, B1 per-half-step three a step and
    one a record, B2 tiling two a K steps), finite lines with NORM within
    1e-3 of 1 (display 77: one a record, t increasing), and every
    engine's 13 display-4 columns at TOL of the routed engine's."""
    grid = getattr(ts, shape)
    model = SuperlatticeModel(parse_cmd(ts.cli_argv(grid)))
    sms = stepper_cuda.card_sms(card)
    routed, runs = CLI_RUNS[shape]
    assert sst.engine_choice(model.NHP, model.MP, model.np_dtype,
                             sms) == routed
    lines = {}
    for display, impl, forced in runs:
        if impl == "stream":
            engine = "stream"
            form = ("tiling" if sst.spill_plan(model.NHP, model.MP,
                                               model.np_dtype, sms) is None
                    else "spill")
        else:
            engine, form = ("cuda-b1", forced) if forced else routed
        steps, chunks, records = ts.run_schedule(model, display)
        text, launches = ts.run_cli(ts.cli_argv(grid, display, impl),
                                    form=forced)
        assert ts.only(launches, ts.expected_launches(
            engine, form, steps, len(chunks),
            records if display == 77 else 0)), (launches, display, impl,
                                                forced)
        rows = ts.rows_of(text)
        assert bool(np.all(np.isfinite(rows)))
        assert bool(np.all(np.abs(rows[:, 6] - 1.0) < 1e-3))
        if display == 4:
            assert rows.shape == (1, 13)
            lines[f"{engine} {form}"] = torch.as_tensor(rows[0])
        else:
            assert rows.shape == (records, 15)
            assert bool(np.all(np.diff(rows[:, 13]) > 0))
    ref = lines.pop(" ".join(routed))
    for tag, row in lines.items():
        ts.allclose(row, ref, what=f"{shape} {tag}", **ts.TOL["f32"])


@pytest.mark.cuda
def test_goldens_on_a_three_band_spill_plan(card, tmp_path):
    """test_display_and_repl_goldens on B2's spill form through a forced
    plan of 3 bands."""
    errs = ts.displays_golden("stream", "spill", str(tmp_path), bands=3)
    assert len(errs) == 13


# ---- sweeps -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("which", ["edc64", "paper"])
def test_sweep_cli_main_paths(card, which):
    """sweep_cli.main on the 64-point E_dc sweep and on the 16 x 16 paper
    map: one B3 launch a chunk of the mode's kind on the cluster form and
    no other kernel, the table's header and parameter columns, every line
    finite with its norm within 1e-3 of 1; the map's av counts are the
    host schedule's."""
    argv = ts.SWEEP_ARGV if which == "edc64" else ts.PAPER_ARGV
    text, sweep, res, launches = ts.run_sweep_cli(argv)
    want = ts._b3_chunk_launches(sweep.n_steps)
    mode, other = ("B3.omega", "B3.shared") if which == "paper" else (
        "B3.shared", "B3.omega")
    assert launches == {"B1": 0, mode: want, other: 0, "cluster": want,
                        "streaming": 0}
    lines = text.splitlines()
    assert lines[0] + "\n" == sweep_cli.HEADER
    rows = np.array([l.split() for l in lines[1:]], float)
    assert rows.shape == ((64 if which == "edc64" else 256), 15)
    assert bool(np.all(np.isfinite(rows)))
    assert float(np.max(np.abs(rows[:, 14] - 1.0))) < 1e-3
    if which == "edc64":
        np.testing.assert_allclose(rows[:, 0], np.linspace(0.1, 3.0, 64),
                                   rtol=1e-11, atol=0)
        return
    E, W = np.meshgrid(np.linspace(0, 3, 16), np.linspace(6, 14, 16),
                       indexing="ij")
    np.testing.assert_allclose(rows[:, 0], E.ravel(), rtol=1e-11, atol=1e-15)
    np.testing.assert_allclose(rows[:, 2], W.ravel(), rtol=1e-11, atol=0)
    np.testing.assert_array_equal(res["av_count"],
                                  ts.expected_av_counts(sweep))


@pytest.mark.cuda
def test_omega_sweep_matches_batched_engine(card):
    """The 16 x 4 omega grid through the per-omega kernel against the
    batched torch engine on the card: av counts exact (and differing per
    point), the observables at 2e-4 rel / 2e-5 abs."""
    kern, _ = ts._sweep_setup("omega16x4", "f32")
    batched, _ = ts._sweep_setup("omega16x4", "f32", impl="torch")
    res = kern.run()
    ts.close_tables(res, batched.run())
    assert len(np.unique(res["av_count"])) > 8


def _frame_files(d, n_points, M):
    """Each point's frame values under d (index.txt, the headers, M + 1
    triplets a phi_x row, the norm within 1e-3 of 1)."""
    with open(os.path.join(d, "index.txt")) as fh:
        idx = fh.read().splitlines()
    assert len(idx) == n_points + 1 and idx[0].startswith("#point")
    X = len(phi_x_grid(np.float32))
    out = []
    for i in range(n_points):
        with open(os.path.join(d, f"point{i:04d}.data")) as fh:
            lines = fh.read().splitlines()
        assert lines[0].startswith("# E_dc=")
        assert lines[-1].startswith("# norm=")
        body = np.array([l.split() for l in lines[1:-1]], float)
        assert body.shape == (X * (M + 1), 3)
        assert bool(np.all(np.isfinite(body)))
        assert abs(float(lines[-1][len("# norm="):]) - 1) < 1e-3
        out.append(body[:, 2])
    return out


@pytest.mark.cuda
def test_sweep_cli_frames_dir(card, tmp_path):
    """frames-dir= on the card: a shared-omega grid through B3, an omega
    grid through its per-omega mode (impl=cuda and impl=auto, one launch
    each on the cluster form) and through the batched engine (impl=torch,
    none); the kernel's frames against the batched engine's at 2e-4 rel /
    2e-5 of the frame's largest value."""
    small = ["E_dc=1", "E_omega=2", "omega=10", "mu=1", "alpha=0.9495",
             "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10", "B=0.1",
             "t-max=0.3", "dt=1e-3", "g-grid=24", "quiet=1"]
    omega = ["sweep:omega=8;12", "sweep:E_dc=0.5;1.5"]
    # (shared, per-omega, cluster-form, streaming-form) launches
    runs = (("fa", "cuda", ["sweep:E_dc=0.5;1.5"], 2, (1, 0, 1, 0)),
            ("fc", "cuda", omega, 4, (0, 1, 1, 0)),
            ("fu", "auto", omega, 4, (0, 1, 1, 0)),
            ("fb", "torch", omega, 4, (0, 0, 0, 0)))
    frames = {}
    for name, impl, grid, n, want in runs:
        tracing.reset()
        assert sweep_cli.main(small + [f"impl={impl}", *grid,
                                       f"o={tmp_path}/{name}.txt",
                                       f"frames-dir={tmp_path}/{name}"]) == 0
        got = (tracing.counted("launches.B3.shared"),
               tracing.counted("launches.B3.omega"),
               *(sum(tracing.counted(f"launches.B3.{m}.{f}")
                     for m in ("shared", "omega"))
                 for f in ("cluster", "streaming")))
        assert got == want, name
        frames[name] = _frame_files(str(tmp_path / name / "grid00"), n, 24)
    for name in ("fc", "fu"):
        for got, ref in zip(frames[name], frames["fb"]):
            assert bool(np.all(np.abs(got - ref) <= 2e-4 * np.abs(ref)
                               + 2e-5 * np.abs(ref).max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["full", "paper"])
def test_sweep_cluster_form_matches_streaming_over_whole_sweeps(card,
                                                                shape):
    """B3's cluster form against its streaming form over the whole 64-point
    sweep and the whole paper map, f32: state and edges (and the map's
    frames) bit for bit, av and captures at TOL."""
    ts.check_cluster_vs_streaming(shape)


@pytest.mark.cuda
def test_sweep_streaming_form_past_cluster_residency(card):
    """8 points at N=100 M=4000 (6.8 MB a point), where no cluster holds a
    point: the E_dc sweep 300 steps and the omega sweep to its end with
    frames, on the streaming form, against the plain versions."""
    _, runner = ts.check_sweep_kernel_vs_plain("wide8", "f32")
    *_, o_runner = ts.check_omega_kernel_vs_plain("omega_wide8", "f32")
    assert runner.form == o_runner.form == "streaming"


@pytest.mark.cuda
def test_bench_sweep_lanes_main_path(card):
    """bench_sweep("lanes"): B4 on its cluster form, one launch a chunk of
    16 points in the warm and the timed call and nothing else; every
    point's av count the schedule's; the observables those of B3 on the
    same sweep."""
    (_, _, _, (sweep, (av, cap, _))), got = ts.counted(
        lambda: bench.bench_sweep("lanes", device=ts.DEVICE))
    calls = 2 * slc.LAUNCHES_PER_CALL * -(-sweep.B // 16)
    assert ts.only(got, {"B4": calls})
    assert (tracing.counted("launches.B4.cluster"),
            tracing.counted("launches.B4.streaming")) == (calls, 0)
    np.testing.assert_array_equal(av[:, 0], ts.expected_av_counts(sweep))
    b3 = bench.make_sweep(device=ts.DEVICE)
    assert b3.engine == "cuda"
    ts.close_tables(slc.observables(sweep, av, cap), b3.run())


def _b1_forms_add_up(launches, engine):
    """B1's launches by form add up to its total, and a run on one of
    B1's forms launched that form and not the other."""
    assert launches["B1"] == (launches["B1 resident"]
                              + launches["B1 per-half-step"]), launches
    for form, other in (("resident", "per-half-step"),
                        ("per-half-step", "resident")):
        if engine == f"cuda-b1 {form}":
            assert launches[f"B1 {form}"] > 0, launches
            assert launches[f"B1 {other}"] == 0, launches


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["sweep", "lanes"],
                                  ["driver", "cuda", "exact", "4"],
                                  ["driver", "stream", "exact", "77"]],
                         ids=" ".join)
def test_bench_cli_line(card, argv):
    """python -m slb2d_tpu_torch.bench as a user runs it: one JSON line
    with a positive rate, the card's nvidia-smi line and the launch
    counts (sweep lanes: B4's alone, one a chunk of the warm and the timed
    call; the `driver` modes: B1's by form adding up)."""
    proc = subprocess.run([sys.executable, "-m", "slb2d_tpu_torch.bench",
                           *argv], cwd=ts.ROOT, capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr[-1500:]
    line = json.loads(lines[0])
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["device"] == bench.device_line()
    if argv[0] == "sweep":
        calls = 2 * slc.LAUNCHES_PER_CALL * -(-bench.SWEEP_POINTS // 16)
        assert ts.only(line["launches"], {"B4": calls})
    else:
        _b1_forms_add_up(line["launches"], re.search(
            r"\[([^\]]+)\]", line["metric"]).group(1))


@pytest.mark.cuda
@pytest.mark.parametrize("argv,depth", [
    (["auto"], {}),
    (["driver", "torch", "fast", "4"],
     dict(N=8, M=64, omega=10.0, t_start=0.01, reps=2)),
    (["cuda"], {}), (["stream"], {}), (["f64"], {}),
    (["torch", "400", "20"], dict(chunk=100, reps=2)),
    (["sweep", "torch"], dict(K=100, reps=2)),
    (["sweep", "stack"], {}), (["sweep", "stack", "omega"], {})],
    ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_bench_mode(card, argv, depth):
    """Every other bench mode once in this process (the plain engines'
    at a cut depth): a positive rate, B1's launches by form adding up
    (its runner modes take the resident form at BASELINE #4)."""
    rec, launches = ts.counted(lambda: bench.run_mode(argv, ts.DEVICE,
                                                      **depth))
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    named = re.search(r"\[([^\]]+)\]", rec["metric"])
    _b1_forms_add_up(launches, "cuda-b1 resident" if argv[0] in (
        "cuda", "f64") else named.group(1) if named else None)


# ---- the probes' main paths -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["P1", "P2", "P3"])
def test_probe_main_paths_launch_what_they_count(card, probe):
    """Each probe's main() path (run) launches its kernels as often as it
    counts them; P1 also bit for bit with its plain version at its full
    shape over 3 turns at every (ILP, block) it was built for; P3's run
    holds every state bit for bit itself."""
    ts.zero_counts()
    if probe == "P1":
        coef, bias, x = vr.make_coeffs()
        xt = torch.from_numpy(x).to(card)
        for fma in (False, True):
            ref = vr.chain_plain(xt, coef, bias, 3, fma)
            assert bool(torch.isfinite(ref).all())
            for ilp in vr.ILPS:
                for block in vr.BLOCKS:
                    got = vr.chain(xt, coef, bias, 3, fma=fma, ilp=ilp,
                                   block=block)
                    assert torch.equal(got, ref), (fma, ilp, block)
        vr.launch_count = 0
        vr.run(ts.DEVICE, configs={v: [vr.CHOSEN[v]] for v in vr.VARIANTS})
        assert vr.launch_count == len(vr.VARIANTS) * 4  # warm-up + 3 timed
    elif probe == "P2":
        rce.run(ts.DEVICE)
        calls = len(rce.AXES) * 4                       # warm-up + 3 timed
        assert (rce.register_launch_count, rce.pass_launch_count) == (
            calls * len(rce.FORMS), calls * 3 * rce.K)
    else:
        te.run(ts.DEVICE)
        calls = 1 + 2 * 4       # the checked run, then 2 turns of 1 + 3
        assert (te.resident_launch_count, te.per_half_step_launch_count) == (
            calls * te.LAUNCHES_PER_CHUNK,
            calls * te.LAUNCHES_PER_STEP * te.K)
        assert te.launch_count == (te.resident_launch_count
                                   + te.per_half_step_launch_count)


# ---- the displays' main paths -----------------------------------------------

@pytest.mark.cuda
def test_display8_at_baseline1(card, tmp_path):
    """BASELINE #1 display 8 on B1 resident, one launch a chunk and no
    other kernel: frame.data against the host f64 frame of the run's final
    state at the D7 envelope, its norm within 1e-3 of 1; that state bit
    for bit with B1's plain version over the run's own av-off tables."""
    cfg = dict(display=8, t_start=10.0, **ts.BASELINE1, **ts.PHYS)
    with ts.in_dir(str(tmp_path)):
        sim, got = ts.counted(lambda: ts.run_sim(cfg, "cuda"))
    chunks = tracing.counted("engine.chunks")
    assert sim.engine_tag() == "cuda-b1 resident"
    assert ts.only(got, {"B1": chunks, "B1 resident": chunks})
    text = (tmp_path / "frame.data").read_text()
    assert text.startswith("# t=")
    assert abs(float(text.split("# norm=")[1].split()[0]) - 1.0) < 1e-3
    ref = sim._get_recon().reconstruct(sim.state.a.cpu().numpy(),
                                       sim.state.b.cpu().numpy(), 1,
                                       sim.model.M + 2)
    vals = np.array([l.split()[2] for l in text.splitlines()
                     if l and not l.startswith("#")], float)
    assert vals.size == ref.size
    ts.allclose(vals.reshape(ref.shape), ref, what="display 8 frame",
                **ts.FRAME_TOL)
    replay, steps = ts.check_schedule_vs_plain(cfg, "BASELINE#1 display 8")
    assert steps == sim.steps_done
    ts._state_equal(sim.state, replay, "display 8 vs its replay")


@pytest.mark.cuda
@pytest.mark.parametrize("frame_batch", [8, 1])
def test_movie_launches_one_kernel_a_chunk(card, frame_batch):
    """The bench's movie at BASELINE #3, frames from t=0.83: B1 resident,
    one launch a chunk and one in warmup, nothing else; at frame-batch 8
    its first 10 chunks (cut at its frames, av off) bit for bit with B1's
    plain version."""
    rec, got = ts.counted(lambda: bench.run_mode(
        ["movie", str(frame_batch)], ts.DEVICE, frame_start=0.83))
    assert rec["engine"] == "cuda-b1 resident" and rec["frames"] >= 8
    assert rec["run_launches"] == rec["chunks"]
    n = rec["chunks"] + 1
    assert ts.only(got, {"B1": n, "B1 resident": n})
    if frame_batch == 8:
        ts.check_schedule_vs_plain(
            dict(display=7, frame_start=0.83, **ts.BASELINE3, **ts.MOVIE),
            "BASELINE#3 movie", max_chunks=10)


@pytest.mark.cuda
def test_display9_split_by_resume_at_baseline1(card, tmp_path):
    """Display 9 at BASELINE #1 (101 periods) on B1 resident, one launch a
    chunk; the same run split at period 40 by checkpoint and resume: the
    101 strobe files byte for byte, the state bit for bit."""
    d9 = dict(display=9, t_start=10.0, **ts.BASELINE1, **ts.PHYS)
    whole, split = tmp_path / "whole", tmp_path / "split"
    with ts.in_dir(str(whole)):
        sim, got = ts.counted(lambda: ts.run_sim(d9, "cuda"))
    chunks = tracing.counted("engine.chunks")
    assert sim.engine_tag() == "cuda-b1 resident"
    assert ts.only(got, {"B1": chunks, "B1 resident": chunks})
    names = sorted(f.name for f in whole.iterdir()
                   if f.name.startswith("strobe"))
    assert len(names) == 101
    with ts.in_dir(str(split)):
        first = Simulation(SimConfig(impl="cuda", quiet=True,
                                     out_file="out.txt", checkpoint="ck.npz",
                                     **d9), device=card)
        D = first.model.np_dtype
        first.t_max = float(D(D(10.0) + D(40 * first.model.T)))
        with contextlib.redirect_stdout(io.StringIO()):
            first.run()
        n_first = sum(f.startswith("strobe") for f in os.listdir("."))
        resumed = ts.run_sim(dict(d9, resume="ck.npz"), "cuda")
    assert resumed.steps_done == sim.steps_done and 30 < n_first < 60
    for name in names:
        assert (whole / name).read_bytes() == (split / name).read_bytes()
    ts._state_equal(resumed.state, sim.state, "display 9 split vs whole")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["B1", "B2"])
def test_repl_main_paths_on_two_forms(card, tmp_path, monkeypatch, engine):
    """A parameter-server session on two forms, one runner each: BASELINE
    #4, three mutations, on B1 resident (one launch a chunk) and the
    forced per-half-step form; N=100 M=20000, one mutation, on B2 spill
    (one launch a chunk) and the forced tiling form.  Finite lines with
    NORM within 1e-3 of 1, the states bit for bit, the headers equal."""
    if engine == "B1":
        cfg = dict(display=4, t_start=10.0, read_from="stdin",
                   **ts.BASELINE4, **ts.PHYS)
        impl, forms, lines = "cuda", (None, "per-half-step"), 4
        script = "E_dc 1.5 0.5\nB 0.2 0.5\nomega 1.2 0.5\nexit\n"
        tags = ("cuda-b1 resident", "cuda-b1 per-half-step")
    else:
        cfg = dict(display=4, t_start=1.0, read_from="stdin", **ts.B2_OWN,
                   **ts.PHYS)
        impl, forms, lines = "stream", (None, "tiling"), 2
        script = "E_dc 1.5 0.2\nexit\n"
        tags = ("stream spill", "stream tiling")
    built = []
    init = stepper_cuda.Runner.__init__

    def counting(self, *a, **k):
        built.append(self)
        init(self, *a, **k)

    monkeypatch.setattr(stepper_cuda.Runner, "__init__", counting)
    out = []
    for form, tag in zip(forms, tags):
        built.clear()
        with ts.forced_form(form), ts.in_dir(str(tmp_path / tag)):
            sim, got = ts.counted(lambda: ts.run_sim(cfg, impl, repl=script))
            with open("out.txt") as fh:
                text = fh.read()
        chunks = tracing.counted("engine.chunks")
        key = {"cuda-b1": "B1", "stream": "B2"}[tag.split()[0]]
        by_form = f"{key} {tag.split()[1]}"
        assert sim.engine_tag() == tag
        assert got[key] > 0 and got[by_form] == got[key], got
        if engine == "B1":
            assert len(built) == 1 and sim._runner is built[0]
            assert ts.only(got, {"B1": got["B1"], by_form: got["B1"]})
        if form is None:
            assert got[key] == chunks, (got, chunks)
        rows = ts.rows_of(text)
        assert rows.shape == (lines, 13) and bool(np.all(np.isfinite(rows)))
        assert bool(np.all(np.abs(rows[:, 6] - 1) < 1e-3))
        out.append((sim, [l for l in text.splitlines() if l.startswith("#")]))
    ts._state_equal(out[0][0].state, out[1][0].state, f"{engine} forms")
    assert out[0][1] == out[1][1]


# ---- shards and the combined layout -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_stream_matches_tiling_form(card, S):
    """The sharded form on S slots against the unsharded tiling form over
    203 steps at N=100 M=20000 f32 with display-77 records: state and
    edges bit for bit (a tile's centre depends only on the cells within
    2K <= H columns), av and records at TOL."""
    model, c, xs, lay, runner = ts._shard_setup(ts.B2_OWN, "f32", S)
    tiling = sst.make_stream_runner(c, model, form="tiling")
    part = {k: v[:203] for k, v in xs.items()}
    emit = (0, 57, 130, 202)
    state0 = stencil.bootstrap_state(c, model)
    sh = lay.gather_state(runner.run_xs(lay.scatter_state(state0), part, 0,
                                        emit_idx=emit))
    one = tiling.run_xs(state0.clone(), part, 0, emit_idx=emit)
    torch.cuda.synchronize()
    ts.same_state(sh, one, f"sharded S={S} vs tiling")
    ts.allclose(sh.av, one.av, what="av", **ts.TOL["f32"])
    ts.allclose(torch.from_numpy(runner.take_obs(len(emit))),
                torch.from_numpy(tiling.take_obs(len(emit))),
                what="d77 records", **ts.TOL["f32"])


def _sharded_run(argv, S, path):
    """Simulation(parse_cmd(argv)) on S slots of the card, its output to
    path: (text, launches by kernel, engine tag)."""
    sim = Simulation(parse_cmd(argv + [f"o={path}"]),
                     mesh=make_mesh((S,), ("space",), devices=[ts.DEVICE] * S))
    _, got = ts.counted(sim.run)
    got["B2 sharded"] = (tracing.counted("launches.B2.sharded_tiles"),
                         tracing.counted("launches.B2.sharded_replays"))
    with open(path) as fh:
        return fh.read(), got, sim.engine_tag()


@pytest.mark.cuda
@pytest.mark.parametrize("display", [4, 77])
def test_sharded_simulation_main_path(card, tmp_path, display):
    """Simulation with shards=2 on two slots of the card at N=100 M=20000,
    BASELINE #4's physics: 2 tile launches and one replay a round of K
    steps, no other kernel; the lines of the unsharded impl=cuda run at
    TOL (display 77: at the d77 golden's f32 tolerance, its t exact)."""
    argv = ts.cli_argv(ts.B2_OWN, display) + ["shards=2"]
    text, got, tag = _sharded_run(argv, 2, str(tmp_path / "s.txt"))
    _, chunks, _ = ts.run_schedule(SuperlatticeModel(parse_cmd(argv)),
                                   display)
    rounds = sum(-(-ch.n_steps // sst.DEFAULT_K) for ch in chunks)
    assert tag == "stream sharded shards=2"
    assert got.pop("B2 sharded") == (2 * rounds, rounds)
    assert not {k: v for k, v in got.items() if k != "B2" and v}, got
    one, _ = ts.run_cli([a for a in argv if a != "shards=2"])
    rows, ref = ts.rows_of(text), ts.rows_of(one)
    assert rows.shape == ref.shape and len(rows) >= 1
    if display == 77:
        np.testing.assert_array_equal(rows[:, 13], ref[:, 13])
    tol = ts.TOL["f32"] if display == 4 else dict(rtol=2e-4, atol=8e-6)
    ts.allclose(rows, ref, what=f"shards=2 display {display}", **tol)


# the two-process run's worker: one slot of cuda:0 a process over Gloo
SHARD_WORKER = r"""
import json, sys
rank, port, out, argv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         json.loads(sys.argv[4]))
import torch
from slb2d_tpu_torch.config import parse_cmd
from slb2d_tpu_torch.parallel.mesh import init_distributed, make_mesh
from slb2d_tpu_torch.runtime.loop import Simulation
assert init_distributed("127.0.0.1:" + port, 2, rank, backend="gloo")
mesh = make_mesh((2,), ("space",), devices=["cuda:0"])
sim = Simulation(parse_cmd(argv + ["o=" + out]), mesh=mesh)
sim.run()
torch.cuda.synchronize()
print(sim.engine_tag(), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.mark.cuda
def test_two_processes_share_the_card(card, tmp_path):
    """The shards=2 display-4 run at N=100 M=20000 by two processes, one
    slot of cuda:0 each, over Gloo: the table byte for byte with one
    process on the same two slots."""
    argv = ts.cli_argv(ts.B2_OWN) + ["shards=2"]
    one, _, _ = _sharded_run(argv, 2, str(tmp_path / "one.txt"))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    worker = tmp_path / "worker.py"
    worker.write_text(SHARD_WORKER)
    out = tmp_path / "two.txt"
    env = dict(os.environ, PYTHONPATH=ts.ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), port,
                               str(out), json.dumps(argv)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
        assert o.strip().endswith("stream sharded shards=2"), o[-500:]
    assert out.read_text() == one


def _ck_state(path):
    z = np.load(path)
    return {k: z[k] for k in z.files if k.startswith("state_")}


def _same_ck(x, y, what):
    for k in ("state_a", "state_b", "state_a_hs", "state_b_hs",
              "state_hs_edge_a", "state_hs_edge_b", "state_t",
              "state_step"):
        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{what} {k}")


def _tables_close(res, ref):
    for k in ref:
        np.testing.assert_allclose(np.asarray(res[k], float),
                                   np.asarray(ref[k], float), err_msg=k,
                                   **ts.OBS_TOL)


@pytest.mark.cuda
def test_combined_full_sweep_on_slots_of_the_card(card, tmp_path,
                                                  monkeypatch):
    """The 64-point E_dc sweep cut to 1,000 steps on a (2, 2) mesh of
    cuda:0 (two blocks of 32 points, each grid over two slots, the batched
    engine: no kernel launched) against the card alone (the state bit for
    bit) and against B3 (the table at 2e-4 / 2e-5); split at step 400 by a
    checkpoint and resumed on the card alone: bit for bit."""
    kw, params = ts.sweep_grid("full")
    cfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True, **kw)

    def make(which):
        if which == "combined":
            sw = ParameterSweep(cfg, params, space_axis="space",
                                mesh=make_mesh((2, 2), ("sweep", "space"),
                                               devices=[card] * 4))
        else:
            sw = ParameterSweep(cfg.replace(impl="cuda" if which == "b3"
                                            else "torch"), params,
                                device=card)
        sw.n_steps = 1000
        return sw

    res, launches, cks = {}, {}, {}
    for which in ("combined", "one", "b3"):
        sw, ck = make(which), str(tmp_path / f"{which}.npz")
        res[which], launches[which] = ts.counted(
            lambda: sw.run(checkpoint=ck))
        cks[which] = _ck_state(ck)
        if which == "combined":
            assert sw.engine == "torch" and len(sw.blocks) == 2
            assert all(sub.layout.S == 2 for _, sub in sw.blocks)
    assert not any(launches["combined"].values())
    assert not any(launches["one"].values())
    assert launches["b3"]["B3"] == 1
    _same_ck(cks["combined"], cks["one"], "combined vs one device")
    _tables_close(res["combined"], res["one"])
    _tables_close(res["combined"], res["b3"])

    class Stop(Exception):
        pass

    save = ParameterSweep._save_checkpoint

    def save_once(self, path, states, cap, done):
        save(self, path, states, cap, done)
        if done < self.n_steps:
            raise Stop

    ck = str(tmp_path / "split.npz")
    monkeypatch.setattr(ParameterSweep, "_save_checkpoint", save_once)
    with pytest.raises(Stop):
        make("combined").run(checkpoint=ck, checkpoint_every=400)
    monkeypatch.setattr(ParameterSweep, "_save_checkpoint", save)
    assert int(np.load(ck)["done"]) == 400
    make("one").run(checkpoint=ck, resume=ck)
    _same_ck(_ck_state(ck), cks["one"], "split on (2, 2), resumed on one")


@pytest.mark.cuda
def test_combined_wide_block_and_frames(card, tmp_path):
    """Two points at N=100 M=20000 with shards=2 on a (1, 2) mesh of
    cuda:0, 100 steps: the state bit for bit with the card alone, the
    table at 2e-4 / 2e-5; a small grid's captured state (52 steps, 4
    points) on a (2, 2) mesh bit for bit with the card alone."""
    wcfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True,
                     shards=2, **{**ts.PHYS, **ts.B2_OWN, "t_start": 0.05})
    wparams = {"E_dc": np.array([0.5, 1.5])}
    res, cks = {}, {}
    for which in ("combined", "one"):
        sw = (ParameterSweep(wcfg, wparams, space_axis="space",
                             mesh=make_mesh((1, 2), ("sweep", "space"),
                                            devices=[card] * 2))
              if which == "combined" else
              ParameterSweep(wcfg.replace(shards=1), wparams, device=card))
        sw.n_steps = 100
        ck = str(tmp_path / f"{which}.npz")
        res[which] = sw.run(checkpoint=ck)
        cks[which] = _ck_state(ck)
    _same_ck(cks["combined"], cks["one"], "wide block")
    _tables_close(res["combined"], res["one"])
    fcfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True,
                     **{**ts.PHYS, "n_harmonics": 8, "g_grid": 24,
                        "omega": 150.0, "t_start": 0.01})
    fparams = {"E_dc": np.linspace(0.25, 2.0, 4)}
    fr = [ParameterSweep(fcfg, fparams, space_axis="space",
                         capture_state=True,
                         mesh=make_mesh((2, 2), ("sweep", "space"),
                                        devices=[card] * 4)),
          ParameterSweep(fcfg, fparams, device=card, capture_state=True)]
    for sw in fr:
        sw.run()
    for x, y in zip(fr[0].final_ab, fr[1].final_ab):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["stream", "torch"])
def test_sharded_runs_hold_no_whole_grid_tensor(card, impl):
    """shards=2 at N=100 M=20000 (B2 sharded, or the plain scan), its
    runner and buffers built: no CUDA tensor of the run is wider than a
    slot's extended slice (L + 2H < MP), the consts' m-indexed fields L
    wide."""
    sim = Simulation(parse_cmd(ts.cli_argv(ts.B2_OWN, impl=impl) + [
        "shards=2", "steps-per-chunk=8"]), mesh=make_mesh(
            (2,), ("space",), devices=[card] * 2))
    sim.warmup()
    MP, L = sim.model.MP, sim.layout.L
    H = sim._runner.geom.H if sim._runner is not None else 0
    for f in M_FIELDS:
        assert all(t.shape[-1] == L for t in getattr(sim.c, f).items), f
    widest = max(t.shape[-1] for _, t in ts.held_tensors(sim)
                 if t.device.type == "cuda" and t.dim())
    assert widest <= L + 2 * H < MP, (widest, L, H, MP)
