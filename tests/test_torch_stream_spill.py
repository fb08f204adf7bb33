"""B2's spill form (ops/stepper_stream_cuda.py spill_plan, csrc/band_step.cuh
spill_band_chunk, csrc/stepper_stream.cu spill_chunk) on the
CPU: which shapes it holds, the budget it plans with against the kernel
source's, its decomposition rehearsed, and the routing among B1's and B2's
forms.

Past the card's shared memory the spill kernel gives each SM a band of
floor or ceil of MP / bands columns: its first R columns resident in shared
memory as B1's resident bands are, the other S in a slab of device memory
with the same layout.  Each part is stepped as a band of its own: the main
half-step on its columns and its a, b halo columns, the half-grid half-step
on its columns, and its a_hs, b_hs halo from the part on each side (the
resident part's right halo from its own slab, the slab's left from its own
resident part, across bands through the exchange buffer).  run_chunk_parts
below is that decomposition in plain PyTorch, each part a (NHP, w + 2) and
(NHP, w + 4) tensor pair stepped with stencil.apply_half_step (the
reciprocal form), the sums added part by part in band order.  It is held
bit for bit to run_chunk_plain (B1's plain version, the spill form's) in
the state and the edges, av and the display-77 records at the sums' order
tolerance (tests/torch_support.py's TOL), and to the JAX package's B2 in
interpret mode at tests/test_torch_stream.py's f32 tolerance.  The kernel
itself is held against run_chunk_plain on a card by
tests/test_torch_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.stepper_stream import make_stream_runner as jax_runner

from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel as TModel
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import stepper_cuda as sc
from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_torch_stepper_resident import (CFG, SUMS_TOL, _band_consts,
                                               _setup, _table, shape_of)

CPU = torch.device("cpu")
DTYPES = {"f32": np.float32, "f64": np.float64}
# against the JAX package's stream kernel: tests/test_torch_stream.py's
# envelope (interpreter ulp class and the sums' order)
JAX_TOL = dict(rtol=1e-4, atol=5e-7)
CSRC = os.path.join(os.path.dirname(sc.__file__), "..", "csrc")


def slabs(NHP, S, bands, item):
    """The bands' slabs: a, b rows of S + 2 values, a_hs, b_hs of S + 4."""
    return bands * NHP * (2 * (S + 2) + 2 * (S + 4)) * item


def smem(NHP, R, item):
    """B1's band of R columns plus the slab rows' products (2 x 128 x 2)."""
    return (2 * NHP * (R + 2) + 2 * NHP * (R + 4) + 33 * 10 + 512) * item


# ---- 1. the plan ------------------------------------------------------

@pytest.mark.parametrize("N,M,dtype,want", [
    (100, 20000, "f32", (132, 128, 25)),    # 152-153 columns, 24-25 spilled
    (100, 24000, "f32", (132, 128, 55)),
    (100, 28000, "f32", (132, 128, 85)),    # slabs + a0 31.0 MB
    (100, 30000, "f32", None),              # 35.1 MB: past the f32 budget
    (400, 6000, "f32", (132, 32, 14)),      # 24.5 MB
    (400, 7000, "f32", None),               # 33.0 MB
    (100, 17000, "f32", (132, 96, 33)),     # 128 columns a band: R=96
    (100, 12000, "f32", None),              # B1's resident plan holds
    (100, 16000, "f32", None),
    (100, 4000, "f32", None),
    (400, 4000, "f32", None),
    (100, 12000, "f64", (132, 64, 28)),     # no resident plan in f64
    (100, 14750, "f64", (132, 64, 49)),     # 35.2 MB, in the f64 budget
    (100, 20000, "f64", None),              # slabs + a0 past the budget
    (400, 4000, "f64", None),               # no band of 32 fits
])
def test_spill_plan_at_the_shapes(N, M, dtype, want):
    """N=100 M=20000 f32: 132 bands of 152-153 columns, R=128 resident
    (219,304 + 2,048 bytes a block), 3,200 columns spilled, 6.2 MB of
    slabs; None wherever B1's resident form holds the state."""
    NHP, MP = shape_of(N, M)
    D = DTYPES[dtype]
    plan = sst.spill_plan(NHP, MP, D)
    if want is None:
        assert plan is None
        return
    item = np.dtype(D).itemsize
    bands, R, S = want
    assert plan == (bands, R, S, smem(NHP, R, item), sc.resident_threads(R),
                    slabs(NHP, S, bands, item))
    assert sc.resident_plan(NHP, MP, D) is None
    if (N, M, dtype) == (100, 20000, "f32"):
        assert MP == 20_096 and plan.smem_bytes == 221_352
        assert plan.spill_bytes == 6_150_144
        assert MP - bands * R == 3_200                # spilled columns
        assert MP // bands == 152 and MP % bands == 32   # ragged bands
        assert plan.threads == 1024


def test_ragged_bands_and_fewer_sms():
    """Fewer SMs take wider bands and more spill; past MAX_SPILL no plan.
    Every band keeps at least HALO_HALF spill columns (R narrows)."""
    assert sst.spill_plan(104, 20096, np.float32, sms=100) == (
        100, 128, 73, smem(104, 128, 4), 1024, slabs(104, 73, 100, 4))
    assert sst.spill_plan(104, 20096, np.float32, sms=66) is None
    # bands of 129 columns: R=128 leaves one; R=96
    p = sst.spill_plan(104, 132 * 129, np.float32)
    assert p.R == 96 and p.S == 33
    # a forced plan ignores B1's resident plan: few bands, narrow R
    assert sst.spill_plan(16, 384, np.float32, sms=5, R=64) == (
        5, 64, 13, smem(16, 64, 4), 1024, slabs(16, 13, 5, 4))
    assert sst.spill_plan(16, 384, np.float32, sms=5) is None   # resident
    assert sst.spill_plan(16, 128, np.float32, sms=2, R=96) is None
    assert sst.spill_plan(16, 128, np.float32, sms=2, R=48) is None


def test_the_budget_bounds_the_plan():
    """The slabs plus a0 within the L2 budget: the plan ends where they
    pass it (or at MAX_SPILL), and a larger budget takes it further."""
    NHP, item = 104, 4
    for MP in range(16_896 + 128, 40_000, 128):
        plan = sst.spill_plan(NHP, MP, np.float32)
        big = sst.spill_plan(NHP, MP, np.float32, budget=2**62)
        if big is None:
            assert -(-MP // 132) - 128 > sst.MAX_SPILL
            assert plan is None
            continue
        fits = big.spill_bytes + NHP * MP * item <= sst.SPILL_L2_BUDGET[4]
        assert (plan is not None) == fits, MP
        if plan is not None:
            assert plan == big


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (-?\d+);", src).group(1))


def test_spill_budget_matches_the_kernel_source():
    """The budget spill_plan computes with is the one the kernel checks
    and allocates (csrc/band_step.cuh, csrc/stepper_stream.cu)."""
    band = open(os.path.join(CSRC, "band_step.cuh")).read()
    stream = open(os.path.join(CSRC, "stepper_stream.cu")).read()
    assert _const(band, "MAX_SPILL") == sst.MAX_SPILL == 128
    assert "constexpr int SPILL_SUMS = 2 * MAX_SPILL * 2;" in band
    assert sst.SPILL_SUMS == 2 * 128 * 2
    for name in ("SMEM_LIMIT", "HALO_MAIN", "HALO_HALF", "BAND_ALIGN",
                 "MAX_BAND", "XCH_LANES", "PART_LANES"):
        assert _const(band, name) == getattr(sc, name), name
    assert ("return slb::resident_smem_bytes<T>(NHP, R) + slb::SPILL_SUMS * "
            "sizeof(T);" in stream)
    assert ("MP / bands - R < HALO_HALF ||\n"
            "      (MP + bands - 1) / bands - R > MAX_SPILL)" in stream)
    assert ("spill_smem_bytes<T>(NHP, R) + RESIDENT_SCRATCH * sizeof(T) >"
            in stream)
    # the slab a band owns in spill_band_chunk: a, b rows of Smax + 2 HALO_MAIN,
    # a_hs, b_hs rows of Smax + 2 HALO_HALF
    assert ("const int GA = Smax + 2 * HALO_MAIN, GH = Smax + 2 * HALO_HALF;"
            in band)
    assert "slab + (size_t)band * NHP * (2 * GA + 2 * GH)" in band
    # every plan passes the kernel's check
    for D in (np.float32, np.float64):
        item = np.dtype(D).itemsize
        for NHP in range(8, 513, 24):
            for MP in range(4096, 40_000, 896):
                p = sst.spill_plan(NHP, MP, D, budget=2**62)
                if p is None:
                    continue
                assert p.R % 32 == 0 and 32 <= p.R <= 512
                assert MP // p.bands - p.R >= 2
                assert -(-MP // p.bands) - p.R == p.S <= 128
                assert p.smem_bytes + 64 * item <= 232_448
                assert p.threads == sc.resident_threads(p.R)
                assert p.threads // p.S >= 2     # rows 0 and 1 apart


# ---- 2. the band-plus-slab decomposition, rehearsed --------------------

def spill_parts(plan, MP):
    """(first column, width) of each part in band order: band k's resident
    part, then its slab."""
    q, rr = divmod(MP, plan.bands)
    parts = []
    for k in range(plan.bands):
        c0 = k * q + min(k, rr)
        wk = q + (1 if k < rr else 0)
        parts += [(c0, plan.R), (c0 + plan.R, wk - plan.R)]
    return parts


def _sums(parts):
    """norm, v_dr, v_y, m_x of the parts' new a, b, added part by part."""
    tot = None
    for part in parts:
        cb, a, b = part["cm"], part["a"][:, 1:-1], part["b"][:, 1:-1]
        w, wphi = cb.w_av[1:-1], cb.w_av_phi[1:-1]
        s = torch.stack([torch.sum(a[0] * w), torch.sum(b[1] * w),
                         torch.sum(a[0] * wphi), torch.sum(a[1] * w)])
        tot = s if tot is None else tot + s
    return tot


def run_chunk_parts(c, state, xs, parity0, emit_idx, bounds):
    """The spill kernel's decomposition in plain PyTorch over parts of
    the grid (`bounds`: (first column, width) in column order, wrapping):
    returns (state, obs) as stepper_cuda.run_chunk_plain does."""
    NHP, MP = state.a.shape
    M = int(torch.nonzero(c.col_edge[0])[0]) - 1
    parts = []
    for c0, w in bounds:
        main = torch.arange(c0 - 1, c0 + w + 1) % MP   # a, b
        half = torch.arange(c0 - 2, c0 + w + 2) % MP   # a_hs, b_hs
        part = {f: getattr(state, f)[:, main].clone() for f in ("a", "b")}
        part.update({f: getattr(state, f)[:, half].clone()
                     for f in ("a_hs", "b_hs")})
        part.update(cm=_band_consts(c, main), ch=_band_consts(c, half),
                    c0=c0, w=w)
        parts.append(part)
    edge_a, edge_b = state.hs_edge_a.clone(), state.hs_edge_b.clone()
    av = state.av
    emit = set(int(i) for i in emit_idx)
    carry = _sums(parts)
    records = []
    step = int(state.step)
    assert step % 2 == parity0

    def pad(x):   # the a_hs window's outer columns: computed, discarded
        return torch.nn.functional.pad(x, (1, 1))

    for i in range(xs.shape[0]):
        row = xs[i]
        ghost_on = (step + 1) % 2 == 0
        for part in parts:   # the main grid on the part and its a, b halo
            cm = part["cm"]
            a, b = ts.apply_half_step(part["ch"], pad(part["a"]),
                                      pad(part["b"]), part["a_hs"],
                                      part["b_hs"], float(row[0]),
                                      float(row[1]), main=True,
                                      use_reciprocal=True)
            part["a"] = a[:, 1:-1] + (cm.a0_ghost if ghost_on
                                      else torch.zeros_like(cm.a0_ghost))
            part["b"] = b[:, 1:-1]
        tot = _sums(parts)
        for part in parts:   # the half grid on the part, against new a, b
            ah, bh = ts.apply_half_step(part["cm"], part["a_hs"][:, 1:-1],
                                        part["b_hs"][:, 1:-1], part["a"],
                                        part["b"], float(row[2]),
                                        float(row[3]), main=False,
                                        use_reciprocal=True)
            ah, bh = ah[:, 1:-1], bh[:, 1:-1]
            if part["c0"] <= M + 1 < part["c0"] + part["w"]:
                j = M + 1 - part["c0"]
                new_ea = part["a_hs"][:, j + 2].clone()
                new_eb = part["b_hs"][:, j + 2].clone()
                ah[:, j], bh[:, j] = edge_a, edge_b
                edge_a, edge_b = new_ea, new_eb
            part["a_hs"][:, 2:-2], part["b_hs"][:, 2:-2] = ah, bh
        k = len(parts)   # each part's a_hs, b_hs halo from its neighbours
        for j, part in enumerate(parts):
            lft, rgt = parts[j - 1], parts[(j + 1) % k]
            for name in ("a_hs", "b_hs"):
                part[name][:, :2] = lft[name][:, -4:-2]
                part[name][:, -2:] = rgt[name][:, 2:4]
        if row[6] > 0:
            av = ts.av_update_from_sums(c, av, tot[1], tot[2], tot[3],
                                        float(row[4]), float(row[5]))
        if i in emit:
            records.append(torch.cat([carry, torch.tensor(
                [row[7]], dtype=av.dtype), av]))
        carry = tot
        step += 1
    out = {f: torch.cat([p[f][:, 1:-1] for p in parts], dim=1)
           for f in ("a", "b")}
    out.update({f: torch.cat([p[f][:, 2:-2] for p in parts], dim=1)
                for f in ("a_hs", "b_hs")})
    obs = None
    if records:
        rec = torch.stack(records)
        obs = torch.zeros((len(records), sc.OBS_LANES), dtype=rec.dtype)
        obs[:, :rec.shape[1]] = rec
    return state.replace(hs_edge_a=edge_a, hs_edge_b=edge_b, av=av,
                         step=state.step + xs.shape[0], **out), obs


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("N,M,bands,R", [
    (8, 64, 2, 32),       # 2 bands of 64: 32 resident, 32 spilled
    (13, 300, 5, 64),     # 5 bands of 76-77, M+1 = 301 in band 3's slab
    (8, 200, 3, 32),      # 3 bands of 85-86: 53-54 spilled
    (8, 24, 3, 32),       # MP=128, 3 bands of 42-43: 10-11 spilled
    (8, 40, 2, 32),       # M+1 = 41 in band 0's slab
])
def test_spilled_version_matches_plain_bit_for_bit(dtype, N, M, bands, R):
    """Two chunks (the first odd, so the second starts at parity 1), with
    display-77 records in both and the averaging window opening in the
    first: state and edges bit for bit, av and records at the sums' order
    tolerance."""
    model, c, runner = _setup(dtype, N, M, t_start=0.02)
    plan = sst.spill_plan(model.NHP, model.MP, model.np_dtype, sms=bands,
                          R=R)
    assert plan is not None and plan.S >= 2
    bounds = spill_parts(plan, model.MP)
    assert sum(w for _, w in bounds) == model.MP
    assert min(w for _, w in bounds[1::2]) >= 2
    xs = _table(runner, 61)
    state0 = ts.bootstrap_state(c, model)
    spilled, plain = state0.clone(), state0.clone()
    for part, emit, parity in ((xs[:31], (0, 5, 30), 0),
                               (xs[31:], (0, 17, 29), 1)):
        spilled, sobs = run_chunk_parts(c, spilled, part, parity, emit,
                                        bounds)
        plain, pobs = sc.run_chunk_plain(c, plain, part, parity, emit)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            assert torch.equal(getattr(spilled, f), getattr(plain, f)), f
        assert int(spilled.step) == int(plain.step)
        assert bool(spilled.av[0] > 0)
        torch.testing.assert_close(spilled.av, plain.av, **SUMS_TOL[dtype])
        assert torch.equal(sobs[:, 4], pobs[:, 4])
        torch.testing.assert_close(sobs, pobs, **SUMS_TOL[dtype])


@pytest.mark.parametrize("bands,R", [(2, 32), (3, 32)])
def test_spilled_version_matches_jax_b2_interpret(bands, R):
    """The rehearsal against the JAX package's B2 (Pallas, interpret mode,
    as tests/test_torch_stream.py runs it) over 100 + 60 steps in f32,
    from one state over the same exact table."""
    cfg = {**CFG, "g_grid": 200}
    jm = JModel(JConfig(**cfg, dtype="f32"))
    jc = js.consts_from_model(jm)
    model, c, runner = _setup("f32", 8, 200)
    plan = sst.spill_plan(model.NHP, model.MP, model.np_dtype, sms=bands,
                          R=R)
    jr = jax_runner(jc, jm, K=8, W=128, exact_trig=True)
    jstate = js.bootstrap_state(jc, jm)
    state = ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)
    done = 0
    for n in (100, 60):
        xs = sc.build_xs_table(model, runner.host, runner.t0, done, n,
                               av_enabled=True, exact=True)
        jstate = jr(jstate, n)
        state, _ = run_chunk_parts(c, state, xs, done % 2, (),
                                   spill_parts(plan, model.MP))
        runner.t0 = float(model.np_dtype(xs[-1, 7] + model.dt))
        done += n
        got = ts.state_to_numpy(state)
        for f in ("a", "b", "a_hs", "b_hs", "av"):
            np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                       err_msg=f, **JAX_TOL)
        for f in ("hs_edge_a", "hs_edge_b"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(jstate, f)))


# ---- 3. the runner's forms and the routing ------------------------------

def test_runner_on_cpu_runs_b1_plain_in_the_spill_form():
    """Forced to the spill form with a forced plan, the runner records
    them, launches and builds nothing, and gives run_chunk_plain's bits;
    the tiling form gives run_chunk_plain_stream's."""
    model, c, _ = _setup("f32")
    plan = sst.spill_plan(model.NHP, model.MP, np.float32, sms=2, R=32)
    runner = sst.make_stream_runner(c, model, form="spill", spill=plan,
                                    exact_trig=True)
    assert runner.form == "spill" and runner.plan == plan
    assert runner.geom is None
    state0 = ts.bootstrap_state(c, model)
    xs = _table(runner, 40)
    got = runner(state0.clone(), 40)
    want, _ = sc.run_chunk_plain(c, state0.clone(), xs, 0)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    tiling = sst.make_stream_runner(c, model, exact_trig=True)
    assert tiling.form == "tiling" and tiling.plan is None
    got = tiling(state0.clone(), 40)
    want, _ = sst.run_chunk_plain_stream(c, state0.clone(), xs, 0, (),
                                         tiling.geom)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert runner.launches == tiling.launches == 0
    assert _build._LOADED is None


def _types_consts():
    """Consts stand-in with what the form choice reads (the device of a0
    and the scalars), so the big grids need no host arrays."""
    import types
    fields = {f: torch.zeros(()) for f in sc.SCALAR_FIELDS}
    return types.SimpleNamespace(a0=torch.zeros((1,)), **fields)


@pytest.mark.parametrize("N,M,dtype,form", [
    (100, 20000, "f32", "spill"),
    (100, 28000, "f32", "spill"),
    (100, 30000, "f32", "tiling"),
    (100, 12000, "f64", "spill"),
    (100, 12000, "f32", "tiling"),
    (100, 4000, "f32", "tiling"),
])
def test_runner_takes_the_plan_form_and_refuses_what_cannot_hold(
        N, M, dtype, form):
    """Without a form the runner takes the spill form where spill_plan
    holds the shape, else the tiling form; a spill form asked for where no
    plan holds raises before anything launches, and nothing falls back."""
    model = TModel(TConfig(**{**CFG, "n_harmonics": N, "g_grid": M},
                           dtype=dtype))
    c = _types_consts()
    runner = sst.StreamRunner(c, model)
    assert runner.form == form
    assert runner.plan == (sst.spill_plan(model.NHP, model.MP,
                                          model.np_dtype)
                           if form == "spill" else None)
    assert sst.StreamRunner(c, model, form="tiling").plan is None
    if form == "tiling":
        with pytest.raises(ValueError, match="cannot hold"):
            sst.StreamRunner(c, model, form="spill")
    with pytest.raises(ValueError, match="no form"):
        sst.StreamRunner(c, model, form="resident")


def _limit_mp():
    """The widest MP at NHP=104 that the f32 spill plan holds."""
    return max(MP for MP in range(16_896, 40_000, 128)
               if sst.spill_plan(104, MP, np.float32) is not None)


@pytest.mark.parametrize("where", ["M=12000", "M=16000", "M=17000",
                                   "M=20000", "limit", "past the limit"])
def test_routing_among_the_forms(monkeypatch, where):
    """impl=cuda and auto: B1 resident where its plan holds; else B2's
    spill form where its plan holds; else B2's tiling form (W >= 4H); else
    B1's per-half-step form.  The engine follows engine_choice."""
    if where.startswith("M="):
        NHP, MP = shape_of(100, int(where[2:]))
    else:
        NHP, MP = 104, _limit_mp() + (128 if where == "past the limit"
                                      else 0)
    want = {"M=12000": ("cuda-b1", "resident"),
            "M=16000": ("cuda-b1", "resident"),
            "M=17000": ("stream", "spill"), "M=20000": ("stream", "spill"),
            "limit": ("stream", "spill"),
            "past the limit": ("stream", "tiling")}[where]
    assert sst.engine_choice(NHP, MP, np.float32) == want
    assert sst.stream_beats_b1(NHP, MP, np.float32) == (want[0] == "stream")
    # f64: B2's spill form where its plan holds (N=100 M=12000), else B1
    # (per-half-step where no resident plan holds)
    assert sst.engine_choice(NHP, MP, np.float64) == (
        ("stream", "spill") if where == "M=12000"
        else ("cuda-b1", "per-half-step"))
    if where.startswith("M="):
        M = int(where[2:])
        cfg = TConfig(**{**CFG, "n_harmonics": 100, "g_grid": M},
                      impl="cuda")
        sim = Simulation.__new__(Simulation)
        sim.cfg, sim.device = cfg, torch.device("cuda:0")
        sim.model = TModel(cfg)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert sim._select_engine() == want[0]


def test_engine_tag_names_the_stream_form():
    """The CLI's # perf: line names B2's form once its runner exists."""
    sim = Simulation.__new__(Simulation)
    sim.engine, sim._runner = "stream", None
    assert sim.engine_tag() == "stream"
    model, c, _ = _setup("f32")
    plan = sst.spill_plan(model.NHP, model.MP, np.float32, sms=2, R=32)
    sim._runner = sst.make_stream_runner(c, model, form="spill", spill=plan)
    assert sim.engine_tag() == "stream spill"
    sim._runner = sst.make_stream_runner(c, model)
    assert sim.engine_tag() == "stream tiling"


@pytest.mark.parametrize("MP,W,tiles", [
    (20_096, 77, 261),     # two full waves (W=121, the most that fits: 167)
    (12_032, 92, 131),     # one wave
    (4_096, 32, 128),
])
def test_tiling_geometry_by_waves(MP, W, tiles):
    """The tiling form's W: the fewest waves x WT over 132 SMs (one tile
    a block), 2H <= W <= what fits in shared memory."""
    g = sst.default_geometry(104, MP, 4)
    assert (g.W, g.n_tiles, g.smem) == (W, tiles, True)
    w_fit = max(w for w in range(16, 200)
                if sst.default_geometry(104, MP, 4, W=w).smem)
    assert w_fit == 121
    cost = {w: -(-(-(-MP // w)) // 132) * (w + 16)
            for w in range(16, w_fit + 1)}
    assert cost[W] == min(cost.values())
    # fewer SMs: more waves, other widths
    assert sst.default_geometry(104, MP, 4, sms=66).n_tiles <= 66 * 3


# ---- 4. the forms' measurements (slb2d_tpu_torch/perf/stream_forms.py) ---

def test_stream_forms_times_each_engine_in_turns():
    """perf.stream_forms on the CPU at N=8 M=64: each engine and form it
    times runs (the runners' plain versions here), in turns a, b, b, a,
    and a runner in another form than asked for is refused."""
    from slb2d_tpu_torch.perf import stream_forms as sf
    calls = []
    real = sf.engine_ms

    def spy(*args, **kw):
        calls.append(args[:4])
        return real(*args, n=3, **kw)

    fns = {"tiling": ((8, 64, "stream", "tiling"), dict(W=32)),
           "per-half-step": ((8, 64, "cuda-b1", "per-half-step"), {})}
    try:
        sf.engine_ms = spy
        t = sf.in_turns(fns, device="cpu", reps=1)
    finally:
        sf.engine_ms = real
    assert [c[3] for c in calls] == ["tiling", "per-half-step",
                                     "per-half-step", "tiling"]
    assert all(len(v) == 2 and min(v) > 0 for v in t.values())
    assert sf.fmt({"a": [0.001, 0.002]}) == "a 1.000/2.000"
    # N=8 M=64 has no spill plan of its own: B2 runs its tiling form
    with pytest.raises(ValueError, match="cannot hold"):
        sf.engine_ms(8, 64, "stream", "spill", device="cpu", n=2, reps=1)


def test_stream_forms_shapes_are_routed_to_their_winners():
    """impl=cuda at the shapes perf.stream_forms times takes the engine
    that was faster there on an H100 (PERF.md §6): the spill form at
    N=100 f32 up to M=28000, f64 M=9000-14750, N=400 M=6000 and N=200
    M=12000; past the f32 budget the tiling form at N=100 M=30000-32000
    (it won at 31000 and 32000) and B1's per-half-step form at N=400
    M=7000."""
    from slb2d_tpu_torch.perf import stream_forms as sf
    spill, tiling = ("stream", "spill"), ("stream", "tiling")
    want = {(100, M, "f32"): spill if M <= 28000 else tiling
            for M in sf.LIMIT_M}
    want.update({(100, M, "f64"): spill for M in sf.F64_M})
    want.update({(400, 6000, "f32"): spill,
                 (400, 7000, "f32"): ("cuda-b1", "per-half-step"),
                 (200, 12000, "f32"): spill})
    assert set(want) >= {(N, M, "f32") for N, M in sf.NHP_SHAPES}
    for (N, M, dtype), choice in want.items():
        m = sf.model_of(N, M, dtype)
        assert sst.engine_choice(m.NHP, m.MP, m.np_dtype) == choice, (N, M)


@pytest.mark.parametrize("argv,rc", [([], 1), (["limit", "bogus"], 2)])
def test_stream_forms_main_refuses_the_cpu(argv, rc, monkeypatch, capsys):
    """main() exits 1 without a card and 2 for an unknown experiment,
    and runs nothing."""
    from slb2d_tpu_torch import perf
    from slb2d_tpu_torch.perf import stream_forms as sf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sf.EXPERIMENTS:
        monkeypatch.setitem(sf.RUNS, name,
                            lambda *a, **k: pytest.fail("ran"))
    assert sf.main(argv) == rc
    out = capsys.readouterr()
    assert out.out == ""
    assert (perf.NO_CARD if rc == 1 else "no experiment bogus") in out.err


# ---- 5. the wide.d4 deployment (benchmark/configs/wide_n100_m20000.json) --

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def _bench_json(*parts):
    import json
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


def _reference_solver():
    """benchmark/reference/solver.py, loaded by path (it imports nothing of
    the program; the benchmark's directory stays off sys.path)."""
    import importlib.util
    import sys
    name = "slb2d_bench_reference_solver"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(BENCH, "reference", "solver.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod     # its dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def test_wide_config_routes_to_the_spill_form():
    """The wide.d4 cell's grid (N=100 M=20000 f32) at 132 SMs: no B1
    resident plan, B2's spill form, 132 bands of 152-153 columns, R=128
    resident and 24-25 in each band's L2 slab."""
    args = _bench_json("configs", "wide_n100_m20000.json")["args"]
    assert args["dtype"] == "f32"
    NHP, MP = shape_of(args["n-harmonics"], args["g-grid"])
    assert (NHP, MP) == (104, 20_096)
    assert sst.engine_choice(NHP, MP, np.float32, sms=132) == (
        "stream", "spill")
    assert sc.resident_plan(NHP, MP, np.float32, 132) is None
    plan = sst.spill_plan(NHP, MP, np.float32, sms=132)
    assert (plan.bands, plan.R, plan.S) == (132, 128, 25)
    slabs = [w for _, w in spill_parts(plan, MP)[1::2]]
    assert set(slabs) == {24, 25} and sum(slabs) == MP - 132 * 128


def test_wide_request_through_simulation_matches_the_reference(monkeypatch):
    """The cell's request (its config's and d4_long's settings, one drawn
    point) at N=8 M=64, cut to t-max=0.05 at omega=40, through Simulation
    with impl=stream on the CPU and the spill form's forced small plan (2
    bands, R=32: the plain version): its display-4 line within 1e-4 of the
    benchmark's plain reference (relative, absolute below 0.01, as the
    benchmark's check), and no b2.* counter while spans record."""
    from slb2d_tpu_torch import config as cfgmod
    from slb2d_tpu_torch import tracing
    conf = _bench_json("configs", "wide_n100_m20000.json")
    mix = _bench_json("traffic", "d4_long.json")
    real = sst.spill_plan

    def forced(NHP, MP, dtype, sms=sc.SM_COUNT, budget=None, R=None):
        return real(NHP, MP, dtype, sms=2, R=32)
    monkeypatch.setattr(sst, "spill_plan", forced)
    point = {"E_dc": 1.7, "E_omega": 2.2, "B": 0.12}
    for k, (lo, hi) in mix["draw"].items():
        assert lo <= point[k] <= hi
    settings = {**conf["args"], **mix["args"], **point,
                "n-harmonics": 8, "g-grid": 64, "t-max": 0.05,
                "omega": 40.0, "impl": "stream", "device": "cpu"}
    cfg = cfgmod.parse_cmd([f"{k}={v}" for k, v in settings.items()])

    class Sink(list):
        write = list.append

        def flush(self):
            pass

        def close(self):
            pass

    sink = Sink()
    before = {k for k in tracing.counters() if k.startswith("b2.")}
    with tracing.recording():
        sim = Simulation(cfg, out=sink)
        sim.run()
    assert sim.engine_tag() == "stream spill"
    assert {k for k in tracing.counters() if k.startswith("b2.")} == before
    lines = [ln for ln in "".join(sink).splitlines()
             if ln.strip() and not ln.startswith("#")]
    assert len(lines) == 1
    ref = _reference_solver()
    got = dict(zip(ref.D4_COLUMNS, map(float, lines[0].split())))
    want, = ref.run_points(
        ref.Grid(N=8, M=64, mu=settings["mu"], alpha=settings["alpha"],
                 phi_y_min=settings["PhiYmin"],
                 phi_y_max=settings["PhiYmax"], dt=settings["dt"],
                 t_start=settings["t-max"]),
        [{"E_dc": 1.7, "E_omega": 2.2, "omega": 40.0, "B": 0.12}])
    for col in ref.OBSERVABLES:
        gap = abs(got[col] - want[col]) / max(abs(want[col]), 1e-2)
        assert gap <= 1e-4, (col, got[col], want[col])


def test_spill_tally_matches_the_kernel_source():
    """The tally spill_band_chunk writes (SPILL_TALLY int64 words a band:
    its step loop's cycles, then those inside the grid barrier) is the
    buffer the runner allocates and passes, and the entry point takes it."""
    band = open(os.path.join(CSRC, "band_step.cuh")).read()
    stream = open(os.path.join(CSRC, "stepper_stream.cu")).read()
    assert _const(band, "SPILL_TALLY") == sst.SPILL_TALLY == 2
    assert "int parity0, T* slab, long long* tally) {" in band
    assert "long long* const mine = tally + SPILL_TALLY * band;" in band
    assert "if (stamp) mine[0] = clock64() - mine[0];" in band
    assert ("atomicAdd(reinterpret_cast<unsigned long long*>(mine + 1),"
            in band)
    assert "(T*)slab, (long long*)tally, N, M, NHP, MP, R," in stream
    assert _build._ENTRY_ARGS["slb_stream_spill_chunk"][:20] == (
        [_build.ctypes.c_void_p] * 19 + [_build.ctypes.c_int])
    model, c, _ = _setup("f32")
    plan = sst.spill_plan(model.NHP, model.MP, np.float32, sms=2, R=32)
    runner = sst.make_stream_runner(c, model, form="spill", spill=plan)
    tally = runner._buffers(CPU)[3]
    assert tally.dtype == torch.int64
    assert tally.shape == (sst.SPILL_TALLY * plan.bands,)
