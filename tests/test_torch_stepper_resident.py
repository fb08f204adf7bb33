"""B1's resident form (ops/stepper_cuda.py resident_plan, csrc/stepper.cu
resident_chunk) on the CPU: which shapes it holds, the budget it plans
with against the kernel source's, and its decomposition rehearsed.

The resident kernel keeps a band of W columns of the state in each
block's shared memory for a whole chunk, a, b with one halo column on
each side and a_hs, b_hs with two; it runs the main half-step on its
columns and on its a, b halo columns (its neighbours' edge columns,
computed from the same inputs), the half-grid half-step on its columns,
and exchanges the two edge columns of a_hs, b_hs on each side once a
step.  run_chunk_banded below is that decomposition in plain PyTorch:
the plan's bands as (NHP, Wb + 2) and (NHP, Wb + 4) tensors, each
half-step applied to every band with stencil.apply_half_step (the
reciprocal form), the av sums added band by band.  It stays a test-side
rehearsal; the kernel itself is held against run_chunk_plain on a card by
tests/test_torch_cuda.py and chip_smoke.py.  Here it is held bit for bit to
run_chunk_plain in the state and the edges (the same per-cell arithmetic;
the wrap of a band's halo is the plain version's roll), av and the
display-77 records at the sums' order tolerance, and to the JAX package's
B1 in interpret mode at tests/test_torch_stepper.py's f32 envelope.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.stepper_pallas import make_pallas_runner

from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel as TModel
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import stepper_cuda as sc
from slb2d_tpu_torch.ops import stepper_stream_cuda as sst
from slb2d_tpu_torch.runtime.loop import Simulation

CPU = torch.device("cpu")
DTYPES = {"f32": np.float32, "f64": np.float64}
CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.1, g_grid=64, dt=1e-3, quiet=True)
# av and records: the band order of the sums against one sum over the
# row, chip_smoke.py's TOL
SUMS_TOL = {"f32": dict(rtol=1e-4, atol=1e-7),
            "f64": dict(rtol=1e-12, atol=1e-14)}
# against the JAX package's kernel: tests/test_torch_stepper.py's envelope
JAX_TOL = dict(rtol=1e-4, atol=1e-7)

SHAPES = {"tall": (400, 4000), "wide": (100, 12000), "BASELINE#4": (100, 4000),
          "N8M64": (8, 64)}


def smem(NHP, W, item):
    """A band's dynamic shared memory: a, b with one halo column a side,
    a_hs, b_hs with two, and 33 rows of the 10-lane xs table."""
    return (2 * NHP * (W + 2) + 2 * NHP * (W + 4) + 33 * 10) * item


def shape_of(N, M):
    m = TModel(TConfig(**{**CFG, "n_harmonics": N, "g_grid": M}))
    return m.NHP, m.MP


# ---- 1. the plan ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_resident_plan_at_the_shapes(name, dtype):
    """The tall grid in f32: 128 bands of 32 columns, 229,800 bytes a
    block; the wide grid: 126 bands of 96 (the last one 32); BASELINE #4
    and N=8 M=64 bands of 32; f64 at the tall and wide grids: None (the
    per-half-step form)."""
    NHP, MP = shape_of(*SHAPES[name])
    plan = sc.resident_plan(NHP, MP, DTYPES[dtype])
    item = np.dtype(DTYPES[dtype]).itemsize
    want = {"tall": (32, 128), "wide": (96, 126), "BASELINE#4": (32, 128),
            "N8M64": (32, 4)}[name]
    if dtype == "f64" and name in ("tall", "wide"):
        assert plan is None
        return
    W, bands = want
    assert plan == (W, bands, smem(NHP, W, item),
                    32 * (W // 32) * (32 // (W // 32)))
    if (name, dtype) == ("tall", "f32"):
        assert plan.smem_bytes == 229_800 and plan.threads == 1024
    if name == "wide":
        assert MP == 12_032 and MP - (bands - 1) * W == 32   # ragged
        assert plan.threads == 960


def test_ragged_bands_and_fewer_sms():
    """A card of fewer SMs takes wider bands; W need not divide MP."""
    assert sc.resident_plan(16, 256, np.float32, sms=3) == (
        96, 3, smem(16, 96, 4), 960)
    assert sc.resident_plan(16, 256, np.float32, sms=8) == (
        32, 8, smem(16, 32, 4), 1024)
    assert sc.resident_plan(104, 4096, np.float32, sms=114) == (
        64, 64, smem(104, 64, 4), 1024)
    # the tall grid needs bands of 32: a card of 114 SMs cannot hold it
    assert sc.resident_plan(408, 4096, np.float32, sms=114) is None
    # bands past MAX_BAND: no plan
    assert sc.resident_plan(16, 128 * 40, np.float32, sms=8) is None


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_every_plan_is_the_narrowest_band_that_fits(dtype):
    """Over NHP = 8..512 (multiples of 8) and MP = 128..16384 (multiples of
    128): a plan is the narrowest multiple of 32 up to 512 that needs at
    most 132 bands, and it exists exactly where that band's arrays with
    their halo, the staged table and the row sums' scratch fit 232,448
    bytes."""
    D = DTYPES[dtype]
    item = np.dtype(D).itemsize
    planned = 0
    for NHP in range(8, 513, 8):
        for MP in range(128, 16385, 128):
            plan = sc.resident_plan(NHP, MP, D)
            W = next(w for w in range(32, 513, 32) if -(-MP // w) <= 132)
            fits = smem(NHP, W, item) + 64 * item <= 232_448
            assert (plan is not None) == fits, (NHP, MP)
            if plan is None:
                continue
            planned += 1
            assert plan.W == W and plan.bands == -(-MP // W) <= 132
            assert (plan.bands - 1) * W < MP <= plan.bands * W
            assert plan.smem_bytes + sc.RESIDENT_SCRATCH * item \
                <= sc.SMEM_LIMIT
    assert planned > 1000


def test_resident_budget_matches_the_kernel_source():
    """The budget resident_plan computes with is the one the kernel checks
    and allocates (csrc/stepper.cu, and csrc/band_step.cuh, which holds
    the band loop it shares with the stream kernel's spill form)."""
    csrc = os.path.join(os.path.dirname(sc.__file__), "..", "csrc")
    src = "".join(open(os.path.join(csrc, f)).read()
                  for f in ("stepper.cu", "band_step.cuh"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (-?\d+);",
                             src).group(1))

    assert const("SMEM_LIMIT") == sc.SMEM_LIMIT == 232_448
    assert const("HALO_MAIN") == sc.HALO_MAIN == 1
    assert const("HALO_HALF") == sc.HALO_HALF == 2
    assert const("XS_STAGE") == sc.XS_STAGE == 32
    assert const("XCH_LANES") == sc.XCH_LANES == 8
    assert const("BAND_ALIGN") == sc.BAND_ALIGN == 32
    assert const("MAX_BAND") == sc.MAX_BAND == 512
    assert const("RESIDENT_BLOCK") == sc.RESIDENT_BLOCK == 1024
    assert const("PART_LANES") == sc.PART_LANES == 4
    assert const("NOT_CO_RESIDENT") == sc.NOT_CO_RESIDENT
    assert "constexpr int SUM_WARPS = MAX_BAND / BAND_ALIGN;" in src
    assert "constexpr int RESIDENT_SCRATCH = 2 * SUM_WARPS * 2;" in src
    assert sc.RESIDENT_SCRATCH == 2 * (512 // 32) * 2
    assert ("((size_t)2 * NHP * (W + 2 * HALO_MAIN) +\n"
            "          (size_t)2 * NHP * (W + 2 * HALO_HALF) +\n"
            "          (size_t)(XS_STAGE + 1) * XS_LANES) * sizeof(T)" in src)
    assert ("resident_smem_bytes<T>(NHP, W) + RESIDENT_SCRATCH * sizeof(T) >"
            in src)
    for W in range(32, 513, 32):
        assert sc.resident_threads(W) <= 1024
        assert sc.resident_threads(W) % W == 0        # whole row groups
        assert sc.resident_threads(W) // W >= 2        # rows 0, 1 apart


# ---- 2. the band decomposition, rehearsed -----------------------------

def _band_consts(c, cols):
    """StencilConsts of the columns `cols` (a band and its halo)."""
    return dataclasses.replace(
        c, a0=c.a0[:, cols], a0_ghost=c.a0_ghost[:, cols], phi=c.phi[cols],
        col_main=c.col_main[:, cols], col_half=c.col_half[:, cols],
        col_edge=c.col_edge[:, cols], w_av=c.w_av[cols],
        w_av_phi=c.w_av_phi[cols])


def _exchange(bands):
    """Each band's two a_hs, b_hs halo columns a side from its neighbours'
    edge columns (the left halo from the left band's last two, the right
    from the right band's first two; band 0's left neighbour is the last
    band)."""
    k = len(bands)
    for i, band in enumerate(bands):
        lft, rgt = bands[i - 1], bands[(i + 1) % k]
        for name in ("a_hs", "b_hs"):
            band[name][:, :2] = lft[name][:, -4:-2]
            band[name][:, -2:] = rgt[name][:, 2:4]


def _sums(bands):
    """norm, v_dr, v_y, m_x of the bands' new a, b, added band by band."""
    tot = None
    for band in bands:
        cb, a, b = band["cm"], band["a"][:, 1:-1], band["b"][:, 1:-1]
        w, wphi = cb.w_av[1:-1], cb.w_av_phi[1:-1]
        part = torch.stack([torch.sum(a[0] * w), torch.sum(b[1] * w),
                            torch.sum(a[0] * wphi), torch.sum(a[1] * w)])
        tot = part if tot is None else tot + part
    return tot


def run_chunk_banded(c, state, xs, parity0, emit_idx, plan):
    """The resident kernel's decomposition in plain PyTorch: returns
    (state, obs) as stepper_cuda.run_chunk_plain does."""
    NHP, MP = state.a.shape
    M = int(torch.nonzero(c.col_edge[0])[0]) - 1
    bands = []
    for k in range(plan.bands):
        c0 = k * plan.W
        wb = min(plan.W, MP - c0)
        main = torch.arange(c0 - 1, c0 + wb + 1) % MP   # a, b
        half = torch.arange(c0 - 2, c0 + wb + 2) % MP   # a_hs, b_hs
        band = {f: getattr(state, f)[:, main].clone() for f in ("a", "b")}
        band.update({f: getattr(state, f)[:, half].clone()
                     for f in ("a_hs", "b_hs")})
        band.update(cm=_band_consts(c, main), ch=_band_consts(c, half),
                    c0=c0, wb=wb)
        bands.append(band)
    edge_a, edge_b = state.hs_edge_a.clone(), state.hs_edge_b.clone()
    av = state.av
    emit = set(int(i) for i in emit_idx)
    carry = _sums(bands)
    records = []
    step = int(state.step)
    assert step % 2 == parity0

    def pad(x):   # the a_hs window's outer columns: computed, discarded
        return torch.nn.functional.pad(x, (1, 1))

    for i in range(xs.shape[0]):
        row = xs[i]
        ghost_on = (step + 1) % 2 == 0
        for band in bands:   # the main grid on the band and its a, b halo
            cm = band["cm"]
            a, b = ts.apply_half_step(band["ch"], pad(band["a"]),
                                      pad(band["b"]), band["a_hs"],
                                      band["b_hs"], float(row[0]),
                                      float(row[1]), main=True,
                                      use_reciprocal=True)
            band["a"] = a[:, 1:-1] + (cm.a0_ghost if ghost_on
                                      else torch.zeros_like(cm.a0_ghost))
            band["b"] = b[:, 1:-1]
        tot = _sums(bands)
        for band in bands:   # the half grid on the band, against the new a, b
            ah, bh = ts.apply_half_step(band["cm"], band["a_hs"][:, 1:-1],
                                        band["b_hs"][:, 1:-1], band["a"],
                                        band["b"], float(row[2]),
                                        float(row[3]), main=False,
                                        use_reciprocal=True)
            ah, bh = ah[:, 1:-1], bh[:, 1:-1]
            if band["c0"] <= M + 1 < band["c0"] + band["wb"]:
                j = M + 1 - band["c0"]
                new_ea = band["a_hs"][:, j + 2].clone()
                new_eb = band["b_hs"][:, j + 2].clone()
                ah[:, j], bh[:, j] = edge_a, edge_b
                edge_a, edge_b = new_ea, new_eb
            band["a_hs"][:, 2:-2], band["b_hs"][:, 2:-2] = ah, bh
        _exchange(bands)
        if row[6] > 0:
            av = ts.av_update_from_sums(c, av, tot[1], tot[2], tot[3],
                                        float(row[4]), float(row[5]))
        if i in emit:
            records.append(torch.cat([carry, torch.tensor(
                [row[7]], dtype=av.dtype), av]))
        carry = tot
        step += 1
    out = {f: torch.cat([band[f][:, 1:-1] for band in bands], dim=1)
           for f in ("a", "b")}
    out.update({f: torch.cat([band[f][:, 2:-2] for band in bands], dim=1)
                for f in ("a_hs", "b_hs")})
    obs = None
    if records:
        rec = torch.stack(records)
        obs = torch.zeros((len(records), sc.OBS_LANES), dtype=rec.dtype)
        obs[:, :rec.shape[1]] = rec
    return state.replace(hs_edge_a=edge_a, hs_edge_b=edge_b, av=av,
                         step=state.step + xs.shape[0], **out), obs


def _setup(dtype, N=8, M=64, **kw):
    model = TModel(TConfig(**{**CFG, "n_harmonics": N, "g_grid": M, **kw},
                           dtype=dtype))
    c = ts.consts_from_model(model, CPU)
    # the exact table: its loop t is the plain state's carried t
    runner = sc.make_cuda_runner(c, model, exact_trig=True)
    return model, c, runner


def _table(runner, n):
    """The first n rows of the table the runner builds from step 0."""
    return sc.build_xs_table(runner.model, runner.host, 0.0, 0, n,
                             av_enabled=runner.av_enabled,
                             exact=runner.exact_trig)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("N,M,sms", [
    (8, 64, 132),       # 4 bands of 32, column M+1 = 65 in band 2
    (8, 200, 3),        # 3 bands of 96, the last 64; M+1 in the last
    (8, 24, 2),         # 2 bands of 64, M+1 = 25 in band 0
    (13, 300, 5),       # NHP=16, 4 bands of 96; row N=13 inside the rows
])
def test_banded_version_matches_plain_bit_for_bit(dtype, N, M, sms):
    """Two chunks (the first odd, so the second starts at parity 1, and
    the ghost fill alternates), with display-77 records in both and the
    averaging window opening in the first: state and edges bit for bit,
    av and records at the sums' order tolerance."""
    model, c, runner = _setup(dtype, N, M, t_start=0.02)
    plan = sc.resident_plan(model.NHP, model.MP, model.np_dtype, sms)
    assert plan is not None and plan.bands >= 2
    xs = _table(runner, 61)
    state0 = ts.bootstrap_state(c, model)
    band, plain = state0.clone(), state0.clone()
    for part, emit, parity in ((xs[:31], (0, 5, 30), 0),
                               (xs[31:], (0, 17, 29), 1)):
        band, bobs = run_chunk_banded(c, band, part, parity, emit, plan)
        plain, pobs = sc.run_chunk_plain(c, plain, part, parity, emit)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            assert torch.equal(getattr(band, f), getattr(plain, f)), f
        assert int(band.step) == int(plain.step)
        assert bool(band.av[0] > 0)
        torch.testing.assert_close(band.av, plain.av, **SUMS_TOL[dtype])
        assert torch.equal(bobs[:, 4], pobs[:, 4])
        torch.testing.assert_close(bobs, pobs, **SUMS_TOL[dtype])


@pytest.mark.parametrize("sms", [132, 2])
def test_banded_version_matches_jax_b1_interpret(sms):
    """The rehearsal against the JAX package's B1 (Pallas, interpret
    mode) over 100 + 60 steps in f32."""
    jm = JModel(JConfig(**CFG, dtype="f32"))
    jc = js.consts_from_model(jm)
    model, c, runner = _setup("f32")
    plan = sc.resident_plan(model.NHP, model.MP, model.np_dtype, sms)
    jr = make_pallas_runner(jc, jm, av_enabled=True, exact_trig=True)
    jstate = js.bootstrap_state(jc, jm)
    state = ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)
    done = 0
    for n in (100, 60):
        xs = sc.build_xs_table(model, runner.host, runner.t0, done, n,
                               av_enabled=True, exact=True)
        jstate = jr(jstate, n)
        state, _ = run_chunk_banded(c, state, xs, done % 2, (), plan)
        runner.t0 = float(model.np_dtype(xs[-1, 7] + model.dt))
        done += n
        got = ts.state_to_numpy(state)
        for f in ("a", "b", "a_hs", "b_hs", "av"):
            np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                       err_msg=f, **JAX_TOL)
        for f in ("hs_edge_a", "hs_edge_b"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(jstate, f)))


# ---- 3. the runner's form ---------------------------------------------

@pytest.mark.parametrize("form", [None, "resident", "per-half-step"])
def test_runner_on_cpu_runs_the_plain_version_in_either_form(form):
    """Forced to a form, the runner records it (and the resident form's
    plan), launches and builds nothing, and gives the plain version's
    bits."""
    model, c, _ = _setup("f32")
    runner = sc.make_cuda_runner(c, model, form=form)
    assert runner.form == (form or "resident")
    assert runner.plan == (sc.resident_plan(model.NHP, model.MP, np.float32)
                           if runner.form == "resident" else None)
    state0 = ts.bootstrap_state(c, model)
    xs = _table(runner, 40)
    got = runner(state0.clone(), 40)
    want, _ = sc.run_chunk_plain(c, state0.clone(), xs, 0)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert runner.launches == 0 and _build._LOADED is None


@pytest.mark.parametrize("dtype,grid,form", [
    ("f64", (400, 4000), "per-half-step"),
    ("f64", (100, 12000), "per-half-step"),
    ("f32", (400, 4000), "resident"),
    ("f64", (100, 4000), "resident"),
])
def test_runner_picks_the_plan_form_and_refuses_what_cannot_hold(
        dtype, grid, form):
    """Without a form the runner takes resident_plan's; a resident form
    asked for where no plan holds the state raises, and nothing falls back
    to the other form."""
    model = TModel(TConfig(**{**CFG, "n_harmonics": grid[0],
                              "g_grid": grid[1]}, dtype=dtype))
    c = types_consts(model)
    runner = sc.Runner(c, model)
    assert runner.form == form
    if form == "per-half-step":
        with pytest.raises(ValueError, match="cannot hold"):
            sc.Runner(c, model, form="resident")
    assert sc.Runner(c, model, form="per-half-step").plan is None
    with pytest.raises(ValueError, match="form"):
        sc.Runner(c, model, form="banded")


def types_consts(model):
    """Consts stand-in with the one attribute the form choice reads (the
    device of a0), so the big grids need no host arrays."""
    import types
    fields = {f: torch.zeros(()) for f in sc.SCALAR_FIELDS}
    return types.SimpleNamespace(a0=torch.zeros((1,)), **fields)


def test_stream_runner_has_no_form():
    """The stream runner has none of B1's forms: where B1's resident plan
    holds the shape it takes its own tiling form, without a plan."""
    model, c, _ = _setup("f32")
    runner = sst.make_stream_runner(c, model)
    assert runner.form == "tiling" and runner.plan is None
    with pytest.raises(ValueError, match="no form"):
        runner._pick_form("resident", CPU)


def test_engine_tag_names_the_b1_form():
    """The CLI's # perf: line names B1's form once its runner exists."""
    sim = Simulation.__new__(Simulation)
    sim.engine, sim._runner = "cuda-b1", None
    assert sim.engine_tag() == "cuda-b1"
    model, c, _ = _setup("f32")
    for form in sc.FORMS:
        sim._runner = sc.make_cuda_runner(c, model, form=form)
        assert sim.engine_tag() == f"cuda-b1 {form}"
    sim.engine, sim._runner = "stream", sst.make_stream_runner(c, model)
    assert sim.engine_tag() == "stream tiling"
    sim.engine, sim._runner = "torch", None
    assert sim.engine_tag() == "torch"
