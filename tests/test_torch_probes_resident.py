"""The probes' resident designs on the CPU: P3's resident form (csrc/
probe_transposed.cu t_resident_chunk, perf/transposed_experiment.py
resident_plan) and P2's register kernels (csrc/probe_roll.cu roll_reg_warp
and roll_reg_halo, perf/roll_cost_experiment.py register_plan).

P3's resident form keeps a band of R rows of the (MP, NHL) state in each
block's shared memory for a chunk, a, b with one halo row on each side and
a_hs, b_hs with two; it runs the main half-step on its rows and its a, b
halo rows, the half-grid half-step on its rows, and exchanges the first
two and last two rows of a_hs, b_hs once a step.  run_banded below is that
decomposition in plain PyTorch, held bit for bit to run_chunk_plain (B1's
plain version transposed).  P2's register kernels hold each line in
registers, V elements a lane; roll_windows below is their scheme (lanes of
V, the shuffle from the lane to the left, a T-element halo refreshed every
`every` passes), held bit for bit to roll_plain and to the JAX probes in
interpret mode.  The plans are held to the kernel sources' budgets.  The
kernels themselves run on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import functools
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.perf import roll_cost_experiment as rce
from slb2d_tpu_torch.perf import transposed_experiment as te

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "slb2d_tpu_torch", "csrc")


def _source(*names):
    return "".join(open(os.path.join(CSRC, n)).read() for n in names)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (-?\d+);", src).group(1))


def smem(NHL, R):
    """A band's dynamic shared memory: a, b with one halo row a side, a_hs,
    b_hs with two, 33 rows of the 10-lane xs table, phi and four mu tables
    of R + 2 rows, float32."""
    return 4 * (2 * (R + 2) * NHL + 2 * (R + 4) * NHL + 33 * 10
                + 5 * (R + 2))


# ---- P3: the resident plan ----------------------------------------------

def test_transposed_plan_at_baseline4():
    """BASELINE #4 (NHP=104, MP=4096, NHL=128): 128 bands of 32 rows,
    73,680 bytes and 1024 threads (8 row groups of 128 lanes) a block."""
    plan = te.resident_plan(104, 4096, 128)
    assert plan == (32, 128, 73_680, 1024) == (32, 128, smem(128, 32), 1024)


@pytest.mark.parametrize("NHP,MP,NHL,sms,want", [
    (104, 4096, 128, 114, (36, 114, smem(128, 36), 1024)),   # last band 28
    (16, 128, 16, 132, (2, 64, smem(16, 2), 32)),     # bands of two rows
    (16, 128, 32, 5, (26, 5, smem(32, 26), 832)),     # last band 24
    (8, 4096, 8, 132, (32, 128, smem(8, 32), 256)),   # the thin shape
    (408, 4096, 512, 132, None),      # the tall grid: past shared memory
    (104, 4096, 102, 132, None),      # NHL not a multiple of 4
    (104, 4096, 64, 132, None),       # NHL below NHP
])
def test_transposed_plan_ragged_and_fewer_sms(NHP, MP, NHL, sms, want):
    assert te.resident_plan(NHP, MP, NHL, sms) == want


def test_every_transposed_plan_is_the_fewest_rows_that_fit():
    """Over NHP = 8..256 (NHL the next multiple of 32) and even MP =
    128..16384: a plan is the fewest even rows up to 512 that need at most
    132 bands, every band at least two rows, and it exists exactly where
    that band fits 232,448 bytes."""
    planned = 0
    for NHP in range(8, 257, 16):
        NHL = -(-NHP // 32) * 32
        for MP in range(128, 16385, 256):
            plan = te.resident_plan(NHP, MP, NHL)
            R = next(r for r in range(2, 513, 2) if -(-MP // r) <= 132)
            assert (plan is not None) == (smem(NHL, R) <= 232_448), (NHP, MP)
            if plan is None:
                continue
            planned += 1
            assert plan.R == R and plan.bands == -(-MP // R) <= 132
            assert MP - (plan.bands - 1) * R >= 2
            assert plan.threads == NHL * min(R, 1024 // NHL) <= 1024
    assert planned > 300


def test_transposed_budget_matches_the_kernel_source():
    """The budget resident_plan computes with is the one the kernel checks
    and allocates (csrc/probe_transposed.cu, with band_step.cuh's shared
    constants)."""
    src = _source("probe_transposed.cu", "band_step.cuh", "half_step.cuh")
    for name in ("SMEM_LIMIT", "HALO_MAIN", "HALO_HALF", "XS_STAGE",
                 "XS_LANES", "RESIDENT_BLOCK", "ROW_ALIGN", "MAX_ROWS",
                 "T_XCH_ROWS", "MU_TABLES", "NOT_CO_RESIDENT"):
        assert _const(src, name) == getattr(te, name), name
    assert ("((size_t)2 * (R + 2 * HALO_MAIN) * NHL +\n"
            "          (size_t)2 * (R + 2 * HALO_HALF) * NHL +\n"
            "          (size_t)(XS_STAGE + 1) * XS_LANES +\n"
            "          (size_t)(MU_TABLES + 1) * (R + 2 * HALO_MAIN)) * "
            "sizeof(float)" in src)
    assert "if (t_resident_smem_bytes(NHL, R) > (size_t)SMEM_LIMIT)" in src
    assert ("if (threads < NHL || threads % NHL != 0 || threads > "
            "RESIDENT_BLOCK ||\n      threads / NHL > R)" in src)
    assert "if (MP - ((MP + R - 1) / R - 1) * R < 2)" in src
    for R in range(2, 513, 2):
        for NHL in (8, 16, 32, 128, 512):
            assert te.resident_threads(NHL, R) <= 1024
            assert te.resident_smem_bytes(NHL, R) == smem(NHL, R)


# ---- P3: the band decomposition, rehearsed --------------------------------

def _band_consts(c, cols):
    """StencilConsts of the columns `cols` of the (NHP, MP) layout: rows of
    the transposed one."""
    return dataclasses.replace(
        c, a0=c.a0[:, cols], a0_ghost=c.a0_ghost[:, cols], phi=c.phi[cols],
        col_main=c.col_main[:, cols], col_half=c.col_half[:, cols],
        col_edge=c.col_edge[:, cols], w_av=c.w_av[cols],
        w_av_phi=c.w_av_phi[cols])


def run_banded(tc, st, xs, parity0, plan):
    """The resident kernel's decomposition in plain PyTorch: each band's
    rows of the (MP, NHL) arrays (a, b with one halo row a side, a_hs, b_hs
    with two), both half-steps band by band (stencil.apply_half_step on the
    band's columns of the (NHP, MP) layout, the reciprocal form), the a_hs,
    b_hs halo rows exchanged after each step.  Returns a new TState."""
    MP, NHP, M, c = tc.MP, tc.NHP, tc.M, tc.c
    bands = []
    for k in range(plan.bands):
        c0 = k * plan.R
        wb = min(plan.R, MP - c0)
        main = torch.arange(c0 - 1, c0 + wb + 1) % MP
        half = torch.arange(c0 - 2, c0 + wb + 2) % MP
        band = {f: getattr(st, f)[main].clone() for f in ("a", "b")}
        band.update({f: getattr(st, f)[half].clone()
                     for f in ("a_hs", "b_hs")})
        band.update(cm=_band_consts(c, main), ch=_band_consts(c, half),
                    c0=c0, wb=wb)
        bands.append(band)
    edge_a, edge_b = st.hs_edge_a.clone(), st.hs_edge_b.clone()

    def nm(x):     # a band's rows as (NHP, rows)
        return x[:, :NHP].t()

    def pad(x):    # the a_hs window's outer columns: computed, discarded
        return torch.nn.functional.pad(x, (1, 1))

    for i in range(xs.shape[0]):
        row = xs[i]
        ghost_on = (i + parity0 + 1) % 2 == 0
        for band in bands:   # the main grid on the band and its halo rows
            cm = band["cm"]
            a, b = ts.apply_half_step(
                band["ch"], pad(nm(band["a"])), pad(nm(band["b"])),
                nm(band["a_hs"]), nm(band["b_hs"]), float(row[0]),
                float(row[1]), main=True, use_reciprocal=True)
            a = a[:, 1:-1] + (cm.a0_ghost if ghost_on
                              else torch.zeros_like(cm.a0_ghost))
            band["a"][:, :NHP], band["b"][:, :NHP] = a.t(), b[:, 1:-1].t()
        for band in bands:   # the half grid on the band's rows
            ah, bh = ts.apply_half_step(
                band["cm"], nm(band["a_hs"])[:, 1:-1],
                nm(band["b_hs"])[:, 1:-1], nm(band["a"]), nm(band["b"]),
                float(row[2]), float(row[3]), main=False,
                use_reciprocal=True)
            ah, bh = ah[:, 1:-1], bh[:, 1:-1]
            if band["c0"] <= M + 1 < band["c0"] + band["wb"]:
                j = M + 1 - band["c0"]
                new_ea = band["a_hs"][j + 2, :NHP].clone()
                new_eb = band["b_hs"][j + 2, :NHP].clone()
                ah[:, j], bh[:, j] = edge_a, edge_b
                edge_a, edge_b = new_ea, new_eb
            band["a_hs"][2:-2, :NHP] = ah.t()
            band["b_hs"][2:-2, :NHP] = bh.t()
        k = len(bands)       # the halo rows from the neighbours' edge rows
        for i_b, band in enumerate(bands):
            lft, rgt = bands[i_b - 1], bands[(i_b + 1) % k]
            for f in ("a_hs", "b_hs"):
                band[f][:2] = lft[f][-4:-2]
                band[f][-2:] = rgt[f][2:4]
    out = {f: torch.cat([band[f][1:-1] for band in bands]) for f in ("a", "b")}
    out.update({f: torch.cat([band[f][2:-2] for band in bands])
                for f in ("a_hs", "b_hs")})
    return te.TState(**out, hs_edge_a=edge_a, hs_edge_b=edge_b)


@pytest.mark.parametrize("N,M,NHL,sms", [
    (8, 64, 16, 132),    # 64 bands of 2 rows: first and last two overlap
    (8, 64, 32, 5),      # 5 bands of 26, the last 24; M+1 = 65 in band 2
    (8, 200, 16, 3),     # 3 bands of 86, the last 84; M+1 in the last
    (13, 300, 32, 4),    # NHP=16, 4 bands of 96; rows n >= N inside
])
def test_banded_transposed_matches_plain_bit_for_bit(N, M, NHL, sms):
    """Two chunks, the first odd so the second starts at parity 1: the
    banded state equals run_chunk_plain's (B1's plain version transposed)
    bit for bit, edges included, and the padding columns stay 0."""
    model, c, tc, state0, xs = te.setup("cpu", N, M, NHL, 41)
    plan = te.resident_plan(model.NHP, model.MP, NHL, sms)
    assert plan is not None and plan.bands >= 3
    band, plain = te.transpose_state(state0, NHL), te.transpose_state(
        state0, NHL)
    for part, parity in ((xs[:21], 0), (xs[21:], 1)):
        band = run_banded(tc, band, part, parity, plan)
        plain = te.run_chunk_plain(tc, plain, part, parity)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            assert torch.equal(getattr(band, f), getattr(plain, f)), f
    for f in ("a", "b", "a_hs", "b_hs"):
        assert bool((getattr(band, f)[:, model.NHP:] == 0).all())
    assert float(plain.a.abs().max()) > 0


@pytest.mark.parametrize("form", te.FORMS)
def test_run_chunk_on_the_cpu_is_the_plain_version_in_either_form(form):
    model, c, tc, state0, xs = te.setup("cpu", 8, 64, 16, 9)
    launches = te.launch_count
    got = te.run_chunk(tc, te.transpose_state(state0, 16), xs, 0, form=form)
    want = te.run_chunk_plain(tc, te.transpose_state(state0, 16), xs, 0)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert te.launch_count == launches


def test_run_chunk_refuses_an_unknown_form():
    model, c, tc, state0, xs = te.setup("cpu", 8, 64, 16, 2)
    with pytest.raises(ValueError, match="form must be one of"):
        te.run_chunk(tc, te.transpose_state(state0, 16), xs, 0,
                     form="banded")


# ---- P2: the register scheme, rehearsed ----------------------------------

def _lines(a, axis):
    """A 2-D tensor's lines along axis as rows."""
    return a.t() if axis == 0 else a


def roll_windows(arrays, axis, K, config, every=None):
    """The register kernels' scheme in plain PyTorch: each line as lanes of
    V elements, a pass x[j] += x[j-1] with element 0 of a lane from the old
    last of the lane to its left.  ("warp", V, 0): P = L / V lanes a line,
    lane 0's left the line's last lane.  ("halo", V, T): L / S windows of
    32 lanes (S = 32·V - T) starting T before their S own elements, lane 0
    of a window its own last element (the shuffle brings nothing), the
    window's first T refreshed from the previous window's last T every
    `every` passes (default T).  The kernel instantiates the halo scheme
    at rce.HALO only; the other (V, T) rehearse the same template.
    Returns new tensors."""
    kind, V, T = config
    L = arrays[0].shape[axis]
    every = T if every is None else every
    if kind == "warp":
        P = L // V
        assert L % V == 0 and P <= 32 and P & (P - 1) == 0, (L, config)
    else:
        S = 32 * V - T
        assert L % S == 0 and L // S <= 32 and T <= S, (L, config)
        assert 1 <= every <= T, every
    out = []
    for a in arrays:
        lines = _lines(a, axis)
        L = lines.shape[1]
        if kind == "warp":
            win = lines.reshape(lines.shape[0], 1, L // V, V).clone()
        else:
            S = 32 * V - T
            idx = (torch.arange(L // S)[:, None] * S - T
                   + torch.arange(32 * V)) % L
            win = lines[:, idx].reshape(lines.shape[0], L // S, 32, V)
        for k in range(K):
            if kind == "halo" and k > 0 and k % every == 0:
                flat = win.reshape(win.shape[0], win.shape[1], 32 * V)
                flat[:, :, :T] = torch.roll(flat[:, :, S:], 1, 1)
                win = flat.reshape(win.shape)
            last = win[..., V - 1]
            left = (torch.roll(last, 1, 2) if kind == "warp" else
                    torch.cat([last[..., :1], last[..., :-1]], 2))
            new = win.clone()
            new[..., 1:] = win[..., 1:] + win[..., :-1]
            new[..., 0] = win[..., 0] + left
            win = new
        if kind == "warp":
            res = win.reshape(lines.shape)
        else:
            flat = win.reshape(win.shape[0], win.shape[1], 32 * V)
            res = flat[:, :, T:].reshape(lines.shape)
        out.append(_lines(res, axis).contiguous())
    return out


ROLL_CASES = [
    # (shape, axis, config, everies): the probe's lines in small arrays
    ((104, 8), 0, ("warp", 13, 0), (None,)),      # 8 lanes a line
    ((8, 128), 1, ("warp", 4, 0), (None,)),       # 32 lanes a line
    ((8, 16), 1, ("warp", 1, 0), (None,)),
    ((2, 1024), 1, ("halo", 17, 32), (None, 7, 1)),    # 2 windows
    ((2, 1024), 1, ("halo", 9, 32), (None,)),          # 4 windows
    ((2, 1024), 1, ("halo", 33, 32), (None, 5)),       # 1, wrapping itself
    ((2, 512), 1, ("halo", 10, 64), (None, 30)),
    ((1024, 2), 0, ("halo", 17, 32), (None, 3)),
]


@pytest.mark.parametrize("form", ["two", "one"])
@pytest.mark.parametrize("shape,axis,config,everies", ROLL_CASES)
def test_register_scheme_matches_plain_bit_for_bit(shape, axis, config,
                                                   everies, form):
    """K=70 passes, two halo refreshes at T=32 and more at smaller every,
    the line's wrap included: bit for bit with roll_plain."""
    x, y = (torch.from_numpy(a) for a in rce.make_inputs(shape))
    arrays = [x, y] if form == "two" else [torch.cat([x, y], 0)]
    if form == "one" and axis == 0 and config[0] == "warp":
        config = rce.register_plan(arrays[0].shape[0])   # lines of 2R
    ref = rce.roll_plain(arrays, axis, 70)
    for every in everies:
        got = roll_windows(arrays, axis, 70, config, every)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (config, every)


def test_register_scheme_without_the_refresh_goes_wrong():
    """The halo does need its refresh: refreshed every T=32 passes the
    windows stay exact over 40 passes; stepped 40 passes without one, their
    first own elements differ from the plain version."""
    x = torch.from_numpy(rce.make_inputs((2, 1024))[0])
    ref = rce.roll_plain([x], 1, 40)[0]
    V, T = 17, 32
    assert torch.equal(roll_windows([x], 1, 40, ("halo", V, T))[0], ref)
    S = 32 * V - T
    idx = (torch.arange(1024 // S)[:, None] * S - T
           + torch.arange(32 * V)) % 1024
    win = x[:, idx]
    for _ in range(40):
        new = win.clone()
        new[..., 1:] = win[..., 1:] + win[..., :-1]
        win = new
    assert not torch.equal(win[..., T:].reshape(2, 1024), ref)


def test_register_scheme_matches_the_pallas_probe():
    """The rehearsal against _kernel_two and _kernel_one (interpret mode),
    3 passes along axis 1 of 8 x 128 arrays."""
    path = os.path.join(ROOT, "tests", "perf", "roll_cost_experiment.py")
    spec = importlib.util.spec_from_file_location("perf_probe_roll", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    x, y = rce.make_inputs((8, 128))
    f32 = np.float32
    two = pl.pallas_call(
        functools.partial(probe._kernel_two, axis=1, K=3),
        out_shape=[jax.ShapeDtypeStruct((8, 128), f32)] * 2,
        interpret=True)(x, y)
    one = pl.pallas_call(
        functools.partial(probe._kernel_one, axis=1, K=3),
        out_shape=jax.ShapeDtypeStruct((16, 128), f32),
        interpret=True)(np.concatenate([x, y]))
    got = roll_windows([torch.from_numpy(x), torch.from_numpy(y)], 1, 3,
                       ("warp", 4, 0))
    for g, j in zip(got, two):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    got = roll_windows([torch.from_numpy(np.concatenate([x, y]))], 1, 3,
                       ("warp", 4, 0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(one))


@pytest.mark.parametrize("L,want", [
    (104, ("warp", 13, 0)), (208, ("warp", 13, 0)), (128, ("warp", 4, 0)),
    (8, ("warp", 1, 0)), (4096, ("halo", 17, 32)), (1024, ("halo", 17, 32)),
    (512, ("halo", 17, 32)),
    (100, None)])
def test_register_plan(L, want):
    assert rce.register_plan(L) == want


def test_register_configs_match_the_kernel_source():
    """WARP_VS and HALO are the instances slb_roll_registers_f32 dispatches
    to, and the block of roll_reg_warp is the source's."""
    src = _source("probe_roll.cu")
    warp = tuple(int(v) for v in re.findall(
        r"case (\d+): return reg_warp<\1>", src))
    halo = tuple((int(v), int(t)) for v, t in re.findall(
        r"if \(V == (\d+) && T == (\d+)\)\n\s+return reg_halo<\1, \2>", src))
    assert warp == rce.WARP_VS
    assert halo == (rce.HALO,)
    assert _const(src, "WARP_BLOCK") == 256


def test_roll_registers_refuses_what_the_kernel_would():
    """Lines or a refresh the kernel would refuse raise before anything
    runs, on the CPU as on a card."""
    launches = rce.register_launch_count
    with pytest.raises(ValueError, match="no halo"):
        rce.roll_registers([torch.zeros((8, 128))], 1, 3, every=5)
    for every in (0, 33):
        with pytest.raises(ValueError, match=f"every={every}"):
            rce.roll_registers([torch.zeros((2, 1024))], 1, 3, every=every)
    with pytest.raises(ValueError, match="lines of 100"):
        rce.roll_registers([torch.zeros((100, 8))], 0, 3)
    assert rce.register_launch_count == launches
