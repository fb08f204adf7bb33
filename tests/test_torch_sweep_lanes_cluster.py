"""The lane-packed sweep kernel's two forms (ops/sweep_lanes_cuda.py,
csrc/sweep_lanes.cu): which form and cluster size a chunk gets, the two
ways the cluster form differs from the packed layout (each point wraps
m+-1 within its own columns; each rank holds a slab of rows and reads its
neighbours' edge rows), and the runner on the CPU whatever size is asked
for.

lanes_cluster_plan is pure arithmetic on a point's shape, the chunk size
and the card's SMs, held here to the kernel source's budget and to the
shapes the sweeps run.  The cluster form's split is rehearsed on the CPU
with the plain version's own arithmetic (stencil.apply_half_step and
lane_rows_step) slab by slab and point by point, and held bit for bit
(value for value: torch.equal) to run_lanes_plain.  The CUDA forms
themselves are held against the plain version on a card by
tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import _build, stencil
from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
from slb2d_tpu_torch.parallel.sweep import ParameterSweep as TSweep

CPU = torch.device("cpu")

# tests/test_torch_sweep_lanes.py's config and grids (N=6 M=29: NHP=8,
# MP=128)
CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=20.0, mu=1.0,
           alpha=0.9495, n_harmonics=6, phi_y_min=-5.0, phi_y_max=5.0,
           B=0.1, t_start=0.02, g_grid=29, dt=1e-3, quiet=True)
GRIDS = {
    "pallas": {"E_dc": np.linspace(0.5, 2.0, 3),
               "E_omega": np.asarray([2.0, 2.0, 0.0])},
    "omega": {"omega": np.asarray([16.0, 20.0, 25.0, 32.0]),
              "E_dc": np.asarray([0.4, 0.9, 1.4, 1.9]),
              "E_omega": np.asarray([2.0, 2.0, 0.0, 1.5])},
    "mu": {"mu": np.asarray([0.8, 1.0, 1.2]),
           "E_dc": np.asarray([0.5, 1.0, 1.5])},
}
FIELDS = ("a", "b", "a_hs", "b_hs", "av", "cap")


def shape_of(**kw):
    """(NHP, MP) of a model with these SimConfig keywords."""
    m = SuperlatticeModel(TConfig(**{**CFG, **kw}))
    return m.NHP, m.MP


def port_sweep(grid, **kw):
    return TSweep(TConfig(**{**CFG, **kw}, impl="torch", dtype="f32"),
                  GRIDS[grid], device=CPU)


# ---- 1. the plan ------------------------------------------------------

def spread_card(cs):
    """A card of 132 SMs on which every cluster size packs its SMs whole
    (an H100 runs only 15 clusters of 8 at once)."""
    return 132 // cs


@pytest.mark.parametrize("N,M,CB,plan,staged", [
    # the bench's 64-point sweep (NHP=48, MP=512) in chunks of 16: 16
    # clusters of 6 blocks of 8 rows in one wave (of 8 only 15 fit), the
    # a0 rows staged
    (40, 500, 16, (6, ((4 + 2) * 8 + 17) * 512 * 4), True),
    # ... in one chunk of 64: 2 blocks of 24 rows, 66 clusters at once,
    # a0 left in device memory
    (40, 500, 64, (2, (4 * 24 + 17) * 512 * 4), False),
    # a 3-point chunk at the same shape spreads to 8 blocks a point
    (40, 500, 3, (8, ((4 + 2) * 6 + 17) * 512 * 4), True),
    # the 3-point lanes grid (NHP=8): 2 rows a rank cap the cluster at 4
    (6, 29, 3, (4, ((4 + 2) * 2 + 17) * 128 * 4), True),
])
def test_lanes_cluster_plan_at_the_sweep_shapes(N, M, CB, plan, staged):
    NHP, MP = shape_of(n_harmonics=N, g_grid=M)
    got = slc.lanes_cluster_plan(NHP, MP, CB)
    assert got == plan
    assert plan[1] in (133_120, 231_424, 108_544, 14_848)
    assert slc.stages_a0(NHP, MP, plan[0]) == staged
    cs, smem = got
    assert CB <= slc.H100_ACTIVE_CLUSTERS[cs] and NHP // cs >= 2
    assert smem + slc.TRIG_SCRATCH * 4 <= slc.SMEM_LIMIT


def test_plan_follows_the_clusters_the_card_runs_at_once():
    """At CB=16, 16 clusters of 8 blocks (6 rows) would run in one wave on
    a card that held them; on an H100, which holds 15, the plan takes 6
    blocks of 8 rows instead of two waves of 6 rows."""
    assert slc.lanes_cluster_plan(48, 512, 16, spread_card)[0] == 8
    assert slc.lanes_cluster_plan(48, 512, 16)[0] == 6
    assert slc.lanes_cluster_plan(48, 512, 15)[0] == 8
    # a size the card cannot run at all is never planned
    assert slc.lanes_cluster_plan(
        48, 512, 16, lambda cs: 0 if cs == 6 else spread_card(cs))[0] == 8
    assert slc.lanes_cluster_plan(48, 512, 16, lambda cs: 0) is None


@pytest.mark.parametrize("grid", [(100, 4000), (100, 12000), (400, 4000)])
def test_points_past_any_cluster_take_the_streaming_form(grid):
    """BASELINE #4's N=100 M=4000 (6.8 MB a point) and the wider and taller
    grids: no portable cluster holds a point, at any chunk size."""
    NHP, MP = shape_of(n_harmonics=grid[0], g_grid=grid[1])
    for CB in (1, 8, 16, 64):
        assert slc.lanes_cluster_plan(NHP, MP, CB) is None
        assert slc.lanes_cluster_plan(NHP, MP, CB, spread_card) is None
    assert all(slc.cluster_smem_bytes(NHP, MP, cs) is None
               for cs in slc.CLUSTER_SIZES)


@pytest.mark.parametrize("card", ["h100", "spread"])
def test_every_plan_follows_the_rule(card):
    """Over NHP = 8..512 (multiples of 8), MP = 128..16384 (multiples of
    128) and several chunk sizes: a size holds a point where it splits NHP
    into equal slabs of >= 2 rows whose arrays, column rows and trig
    buffer fit SMEM_LIMIT; the plan is the size that holds it with the
    fewest waves (ceil(CB / clusters at once)) times rows a block, the
    larger on a tie, or None where no size holds it; its shared memory
    has the a0 rows too where they fit."""
    active = (slc.H100_ACTIVE_CLUSTERS.__getitem__ if card == "h100"
              else spread_card)
    planned = 0
    for NHP in range(8, 513, 8):
        for MP in range(128, 16385, 128):
            fits = [cs for cs in range(1, 9) if NHP % cs == 0
                    and NHP // cs >= 2
                    and ((4 * (NHP // cs) + 17) * MP + 16) * 4 <= 232_448]
            for CB in (1, 3, 16, 64, 200):
                plan = slc.lanes_cluster_plan(NHP, MP, CB, active)
                if not fits:
                    assert plan is None, (NHP, MP, CB)
                    continue
                planned += 1
                cost = {cs: -(-CB // active(cs)) * (NHP // cs)
                        for cs in fits}
                want = max(cs for cs in fits
                           if cost[cs] == min(cost.values()))
                cs, smem = plan
                assert cs == want, (NHP, MP, CB)
                R = NHP // cs
                staged = ((6 * R + 17) * MP + 16) * 4 <= 232_448
                assert smem == ((6 if staged else 4) * R + 17) * MP * 4
                assert slc.stages_a0(NHP, MP, cs) == staged
    assert planned > 1000


def test_cluster_budget_matches_the_kernel_source():
    """The budget lanes_cluster_plan computes with is the one the kernel
    checks and allocates (csrc/sweep_lanes.cu), as the per-point columns
    are held by test_lane_constants_match_the_kernel_source."""
    src = open(os.path.join(os.path.dirname(slc.__file__), "..", "csrc",
                            "sweep_lanes.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (-?\d+);",
                             src).group(1))

    assert const("SMEM_LIMIT") == slc.SMEM_LIMIT == 232_448
    assert const("SLAB_ARRAYS") == slc.SLAB_ARRAYS == 4
    assert const("A0_ARRAYS") == slc.A0_ARRAYS == 2
    # 8 av rows, 4 capture rows (the LaneState's av and cap), the weight
    # rows and phi
    assert const("COLUMN_ROWS") == slc.COLUMN_ROWS == (
        8 + len(slc.CAP_KEYS) + len(slc.W_ROWS) + 1)
    assert const("TRIG_SCRATCH") == slc.TRIG_SCRATCH
    assert const("NO_ACTIVE_CLUSTER") == slc.NO_ACTIVE_CLUSTER
    # two steps' buffers of TRIG_SLOTS, TRIG_VALUES of them used
    assert 2 * const("TRIG_VALUES") <= slc.TRIG_SCRATCH
    assert "TRIG_SLOTS = TRIG_SCRATCH / 2" in src
    # every size up to the portable 8 that splits NHP into equal slabs
    assert slc.CLUSTER_SIZES == tuple(range(1, const("CLUSTER_MAX") + 1))
    assert "NHP % cs != 0 || NHP / cs < 2" in src
    assert ("((size_t)(SLAB_ARRAYS + (staged ? A0_ARRAYS : 0)) * R +\n"
            "          COLUMN_ROWS) * MP * sizeof(float)") in src
    assert ("smem + TRIG_SCRATCH * sizeof(float) <= (size_t)SMEM_LIMIT"
            in src)
    assert "within_budget(cluster_smem_bytes(R, MP, true))" in src
    assert const("CLUSTER_BLOCK") == 1024
    assert "slb_lanes_cluster" in _build._ENTRY_ARGS
    assert "slb_lanes_form_info" in _build._ENTRY_ARGS


# ---- 2. the segment wrap ----------------------------------------------

@functools.lru_cache(maxsize=None)
def port_lanes(grid, max_points=16):
    return slc.run_sweep_lanes(port_sweep(grid), max_points=max_points)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_each_point_alone_matches_one_chunk(grid):
    """max_points=1: every point is a pack of its own, so its m+-1 reads
    wrap within its own MP columns, as a cluster holding one point wraps
    them; in one chunk they reach the neighbouring segment.  Those reads
    land only in ghost columns, so the two give the same values: state,
    av and capture sums bit for bit."""
    av1, cap1, st1 = port_lanes(grid)
    av2, cap2, st2 = port_lanes(grid, max_points=1)
    np.testing.assert_array_equal(av2, av1)
    for k in cap1:
        np.testing.assert_array_equal(cap2[k], cap1[k])
    for x1, x2 in zip(st1, st2):
        np.testing.assert_array_equal(x2, x1)


# ---- 3. the rank split, rehearsed -------------------------------------

def _slab_consts(c, rows, cols):
    """pack.consts restricted to the rows (a list, halo rows included) and
    one point's columns."""
    per_col = {f: getattr(c, f)[..., cols] for f in (
        "E_dc", "E_omega", "omega", "B", "bdt", "col_main", "col_half",
        "col_edge")}
    per_row = {f: getattr(c, f)[rows] for f in (
        "n_float", "row_update", "n_ge2", "w_n", "b_row_mask")}
    return dataclasses.replace(
        c, a0=c.a0[rows][:, cols], a0_ghost=c.a0_ghost[rows][:, cols],
        phi=c.phi[cols], **per_col, **per_row)


def run_lanes_clustered(pack, st, n_steps, cs, step0=0, t0=0.0):
    """The cluster form's split on the CPU: every point of the pack on its
    own (its columns only, m+-1 wrapping within them), cut into cs slabs
    of R = NHP / cs rows; each slab's half-step reads its rows and, as the
    halo, the previous rank's last and the next rank's first row (wrapped
    over the point's rows).  The two phases of a step run in the kernel's
    order: every slab's main half-step, then every slab's half-grid
    half-step against the new a, b, then each point's av and capture rows
    from rank 0's rows 0-1."""
    c = pack.consts
    CB = pack.seg.shape[0]
    NHP, BMP = st.a.shape
    MP, R = BMP // CB, NHP // cs
    assert NHP % cs == 0 and R >= 2
    dt = c.dt
    a, b, ahs, bhs = st.a.clone(), st.b.clone(), st.a_hs.clone(), \
        st.b_hs.clone()
    av, cap = st.av.clone(), st.cap.clone()
    t = torch.tensor(t0, dtype=a.dtype)
    edge_col = int(torch.nonzero(c.col_edge[0, :MP])[0])
    for i in range(n_steps):
        gf = 1.0 if (step0 + i + 1) % 2 == 0 else 0.0
        t_hs = t + dt / 2
        for main in (True, False):
            dst = (a, b) if main else (ahs, bhs)
            nb = (ahs, bhs) if main else (a, b)
            out = [torch.empty_like(dst[0]), torch.empty_like(dst[1])]
            for s in range(CB):
                cols = slice(s * MP, (s + 1) * MP)
                for r in range(cs):
                    rows = [(r * R + k) % NHP for k in range(-1, R + 1)]
                    cc = _slab_consts(c, rows, cols)
                    tt = t if main else t_hs
                    an, bn = stencil.apply_half_step(
                        cc, dst[0][rows][:, cols], dst[1][rows][:, cols],
                        nb[0][rows][:, cols], nb[1][rows][:, cols],
                        torch.cos(cc.omega * tt),
                        torch.cos(cc.omega * (tt + dt)), main=main,
                        use_reciprocal=True)
                    an, bn = an[1:-1], bn[1:-1]
                    if main:
                        an = an + gf * cc.a0_ghost[1:-1]
                    else:
                        ea = torch.zeros_like(an)
                        eb = torch.zeros_like(bn)
                        ea[:, edge_col] = pack.edge_a[s, r * R:(r + 1) * R]
                        eb[:, edge_col] = pack.edge_b[s, r * R:(r + 1) * R]
                        an = an + gf * ea
                        bn = bn + gf * eb
                    out[0][r * R:(r + 1) * R, cols] = an
                    out[1][r * R:(r + 1) * R, cols] = bn
            if main:
                a, b = out
            else:
                ahs, bhs = out
        for s in range(CB):
            cols = slice(s * MP, (s + 1) * MP)
            seg = pack.seg[s]
            av[:, cols], cap[:, cols] = slc.lane_rows_step(
                c.omega[:, cols], c.t_start, dt, pack.w[:, cols],
                seg[slc.SEG_EGATE], seg[slc.SEG_TEND], av[:, cols],
                cap[:, cols], a[0:2, cols], b[0:2, cols], t)
        t = t + dt
    return slc.LaneState(a=a, b=b, a_hs=ahs, b_hs=bhs, av=av, cap=cap)


@pytest.mark.parametrize("grid,N,cs", [
    ("omega", 6, 1), ("omega", 6, 2), ("omega", 6, 4),   # NHP=8
    ("pallas", 40, 8), ("omega", 40, 6), ("mu", 40, 2),  # NHP=48
    ("pallas", 40, 3),
])
def test_rank_split_matches_plain(grid, N, cs):
    """The rehearsal against run_lanes_plain over 61 steps from step 0 and
    then 40 from step 61 (parity 1, the loop t continued), every field bit
    for bit: the slabs, their halo rows, the per-point wrap and rank 0's
    column rows give the packed plain version's values."""
    sw = port_sweep(grid, n_harmonics=N)
    runner = slc.make_sweep_lanes_runner(sw)
    pack = runner.packs[0]
    plain = clus = runner.start(0)
    for step0, n in ((0, 61), (61, 40)):
        t0 = runner.loop_t(step0)
        plain = slc.run_lanes_plain(pack, plain, n, step0, t0)
        clus = run_lanes_clustered(pack, clus, n, cs, step0, t0)
    for f in FIELDS:
        assert torch.equal(getattr(clus, f), getattr(plain, f)), f
    assert bool((plain.av[0] > 0).any()) and bool((plain.cap != 0).any())


# ---- 4. the runner on the CPU -----------------------------------------

@pytest.mark.parametrize("cluster_size", [None, 0, 4])
def test_runner_on_cpu_runs_the_plain_version_at_any_size(cluster_size):
    """The runner forced to each form records it, launches and builds
    nothing, and gives the plain version's bits, over a run split at an
    odd step."""
    sw = port_sweep("omega")
    runner = slc.make_sweep_lanes_runner(sw, cluster_size=cluster_size)
    want = 4 if cluster_size is None else cluster_size
    assert runner.cluster_size == want
    assert runner.form == ("streaming" if want == 0 else "cluster")
    assert runner.smem_bytes == (
        0 if want == 0 else ((4 + 2) * 8 // want + 17) * 128 * 4)
    pack = runner.packs[0]
    got = runner.advance(0, runner.start(0), 151)
    got = runner.advance(0, got, sw.n_steps - 151, step0=151)
    ref = slc.run_lanes_plain(pack, runner.start(0), 151)
    ref = slc.run_lanes_plain(pack, ref, sw.n_steps - 151, 151,
                              runner.loop_t(151))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert runner.launches == 0 and _build._LOADED is None


@pytest.mark.parametrize("cluster_size", [3, 8, 16])
def test_runner_refuses_sizes_that_cannot_hold_the_point(cluster_size):
    """Not a portable size (3, 16), or 1 row a rank (8 at NHP=8): refused
    at construction; nothing falls back to another size."""
    with pytest.raises(ValueError, match="cannot hold"):
        slc.make_sweep_lanes_runner(port_sweep("pallas"),
                                    cluster_size=cluster_size)


def test_runner_past_cluster_residency_takes_the_streaming_form():
    """Two points at N=100 M=4000: the plan is None, so the runner takes
    the streaming form, and a forced cluster raises before any launch."""
    sw = port_sweep("pallas", n_harmonics=100, g_grid=4000)
    runner = slc.make_sweep_lanes_runner(sw)
    assert (runner.form, runner.cluster_size, runner.smem_bytes) == (
        "streaming", 0, 0)
    for cs in slc.CLUSTER_SIZES:
        with pytest.raises(ValueError, match="cannot hold"):
            slc.make_sweep_lanes_runner(sw, cluster_size=cs)
