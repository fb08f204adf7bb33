"""Chunked full-step runner for grids past B1's resident plan on the
hand-written CUDA kernels of csrc/stepper_stream.cu: the port of the JAX
package's stream engine (slb2d_tpu/ops/stepper_stream.py:
make_stream_runner, kernel B2), in two forms.

  * spill: ONE cooperative launch per chunk, one block per SM (csrc/
    band_step.cuh, B1's resident band loop): each block keeps R columns of
    its band in shared memory and the rest of the band (S columns) in a
    slab of device memory that stays in L2.  spill_plan sizes it; it holds
    f32 and f64 grids that no B1 resident plan holds, up to an L2 budget
    (SPILL_L2_BUDGET).  Its plain version is B1's (run_chunk_plain).
  * tiling: the TPU kernel's temporal tiling.  The phi_y axis is cut into
    tiles of W center columns with an H-column halo on each side; each
    launch advances every tile K full steps on its own (2K <= H keeps the
    centers exact), and a one-block replay adds the tiles' per-step center
    sums in tile order and runs the av() chain and the display-77 records
    from them.  A chunk is ceil(n/K) such pairs of launches from one C
    call.  The geometry is chosen for an H100, not copied from the TPU's
    (W=2048, H=128, K=64): K=4, H=8, and W by the fewest waves x WT over
    the card's SMs; the working tiles live in shared memory where four
    (NHP, W+2H) arrays fit in a block's 227 KB, else in a per-block scratch
    in global memory (default_geometry).  K=4 was the fastest of K = 2..16
    at N=100 M=4000 and within 2% of the fastest at N=100 M=12000 (H100
    80GB HBM3, 700 W; PERF.md §6).  Its plain version is
    ``run_chunk_plain_stream``.

The runner takes the spill form where spill_plan holds the shape, the
tiling form elsewhere, or the form asked for; a form that cannot hold the
shape raises before anything launches.  engine_choice is impl=cuda's and
impl=auto's choice among B1's and B2's forms.

Contract: on a CUDA device the state's tensors (a, b, a_hs, b_hs, the
edges and av) are updated in place, as the B1 Runner updates them; the
tiling form keeps a second buffer set that launches ping-pong with, and
copies the result back after an odd number of launches.  On CPU tensors
the runner runs its form's plain version, which returns new tensors.  On
CUDA tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import stencil
from .stepper_cuda import (BAND_ALIGN, HALO_HALF, HALO_MAIN,
                           LAUNCHES_PER_CHUNK, MAX_BAND, OBS_LANES,
                           PART_LANES, RESIDENT_SCRATCH, SM_COUNT,
                           SMEM_LIMIT, XCH_LANES, Runner, card_sms,
                           resident_plan, resident_smem_bytes,
                           resident_threads, run_chunk_plain)

# halo columns per step of a launch (two half-steps of an m±1 stencil)
HALO_PER_STEP = 2
DEFAULT_K = 4
MAX_K = 32                    # the replay kernel's table (REPLAY_BLOCK / 4)
# dynamic shared memory a tile may use: 227 KB per block less the block
# sums' static table
SMEM_BUDGET = 225 * 1024

# kernel launches per K steps of the tiling form: the tiles, the replay
LAUNCHES_PER_LAUNCH = 2

FORMS = ("spill", "tiling")

# The spill form's budget beside B1's resident one (csrc/band_step.cuh,
# whose constants of the same names tests/test_torch_stream_spill.py holds
# to these): the widest spill a band may have, and the elements of
# dynamic shared memory that hold its rows 0 and 1's products.
MAX_SPILL = 128
SPILL_SUMS = 2 * MAX_SPILL * 2
# The most bytes of slabs plus a0 that the spill form is planned with, by
# item size (the L2 that they share is 50 MB on an H100): the spill form
# against the engine impl=cuda would take instead, per step in turns on an
# H100 80GB HBM3 at 700 W (python -m slb2d_tpu_torch.perf.stream_forms;
# PERF.md §6).  f32: won up to 31.0 MB (N=100 M=28000: 47.6-48.2 against
# the tiling form's 56.8-56.9 us), lost at 33.0 MB (N=400 M=7000:
# 78.9-81.8 against B1's per-half-step form's 76.2 us).  f64: won at 35.2
# MB, its widest plan at N=100 (M=14750: 62.0-62.2 against the
# per-half-step form's 81.1 us).
SPILL_L2_BUDGET = {4: 30 * 1024 * 1024, 8: 34 * 1024 * 1024}

# kernel launches made by every stream runner of this process (each runner
# also counts its own in .launches), in all and per form; reset them
# before a run and read them after to show the run went through the kernel
launch_count = 0
spill_launch_count = 0
tiling_launch_count = 0


class SpillPlan(NamedTuple):
    bands: int        # blocks of the launch, one per SM
    R: int            # resident columns of a band (shared memory)
    S: int            # spill columns of the widest band (the slab)
    smem_bytes: int   # dynamic shared memory a block
    threads: int      # threads a block
    spill_bytes: int  # the bands' slabs


def spill_smem_bytes(NHP: int, R: int, dtype) -> int:
    """The spill form's dynamic shared memory: the resident part of a
    band of R columns (B1's band) and the slab rows' products."""
    return (resident_smem_bytes(NHP, R, dtype)
            + SPILL_SUMS * np.dtype(dtype).itemsize)


def slab_bytes(NHP: int, S: int, bands: int, dtype) -> int:
    """The bands' slabs: a, b rows of S + 2 values and a_hs, b_hs rows of
    S + 4, NHP rows each, per band."""
    return (bands * NHP * (2 * (S + 2 * HALO_MAIN) + 2 * (S + 2 * HALO_HALF))
            * np.dtype(dtype).itemsize)


def spill_plan(NHP: int, MP: int, dtype, sms: int = SM_COUNT,
               budget: int | None = None, R: int | None = None):
    """The spill form's SpillPlan for an (NHP, MP) state of dtype on a
    card of `sms` SMs, or None: where B1's resident plan holds the state
    (unless R is given), or where no plan does.  Bands: one per SM, of
    floor or ceil of MP / sms columns (the fewest spill columns an SM);
    R: the widest multiple of BAND_ALIGN up to MAX_BAND whose resident
    part, row sums and slab products fit SMEM_LIMIT and leave every band
    at least HALO_HALF spill columns (or R as given); S = ceil(MP / sms) -
    R, at most MAX_SPILL; the slabs plus a0 within `budget` bytes (by
    default SPILL_L2_BUDGET of the dtype's item size).  N=100
    M=20000 (NHP=104, MP=20,096) in f32: 132 bands of 152-153 columns, R=128,
    S=25, 221,352 bytes a block, 6.2 MB of slabs."""
    if R is None and resident_plan(NHP, MP, dtype, sms) is not None:
        return None
    item = np.dtype(dtype).itemsize
    budget = SPILL_L2_BUDGET[item] if budget is None else budget
    q = MP // sms
    widths = [R] if R is not None else range(MAX_BAND, 0, -BAND_ALIGN)
    for r in widths:
        smem = spill_smem_bytes(NHP, r, dtype)
        if (NHP < 2 or r < BAND_ALIGN or r % BAND_ALIGN
                or smem + RESIDENT_SCRATCH * item > SMEM_LIMIT
                or q - r < HALO_HALF):
            continue
        S = -(-MP // sms) - r
        spill = slab_bytes(NHP, S, sms, dtype)
        if S > MAX_SPILL or spill + NHP * MP * item > budget:
            return None
        return SpillPlan(sms, r, S, smem, resident_threads(r), spill)
    return None


def spill_form_info(dtype, plan: SpillPlan, NHP: int, MP: int) -> dict:
    """What the spill form takes on the current card at `plan`: registers
    and local (spill) bytes a thread, dynamic and static shared memory and
    threads a block, and the blocks that run at once on the whole card.
    Builds the kernels first; needs a card."""
    import ctypes
    from . import _build
    out = (ctypes.c_int * 6)()
    rc = _build.load().cdll.slb_stream_spill_info(
        int(np.dtype(dtype) == np.float64), plan.R, plan.bands, NHP, MP,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"stream spill form query ({plan}, NHP={NHP}, "
                           f"MP={MP}) failed: cudaError_t {rc}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_at_once=out[3], threads=out[4],
                static_smem_bytes=out[5])


class Geometry(NamedTuple):
    K: int          # full steps per launch
    H: int          # halo columns per side, >= 2K
    W: int          # center columns per tile
    n_tiles: int    # ceil(MP / W)
    smem: bool      # working tiles in shared memory (else global scratch)

    @property
    def WT(self) -> int:
        return self.W + 2 * self.H


def default_geometry(NHP: int, MP: int, itemsize: int, K: int | None = None,
                     W: int | None = None, sms: int = SM_COUNT) -> Geometry:
    """K steps per launch (default 4), H = 2K, and W: given, or the
    width from 2H (halo overhead at most 2x) up to what fits in shared
    memory (four (NHP, W+2H) arrays and the edge chain in SMEM_BUDGET)
    with the fewest waves x WT, a wave being `sms` tiles (one block of
    1024 threads an SM), the widest on a tie; where not even 2H fits,
    enough columns for one wave of tiles in global scratch.  Tiles go to
    shared memory when they fit, else to global scratch.  In f32 on an
    H100 80GB HBM3 at 700 W, in turns (perf.stream_forms): N=100 M=20000
    (MP=20,096), W=77, 261 tiles in two full waves, 42.4-42.6 us a step
    against 59.9-60.0 at W=121, the most that fits (167 tiles); N=400
    M=4000, W=16 (256 tiles) 51.2-51.3 against 56.8-56.9 at W=18 (228)."""
    K = DEFAULT_K if K is None else int(K)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}")
    H = HALO_PER_STEP * K
    col_bytes = 4 * NHP * itemsize
    w_fit = (SMEM_BUDGET - 2 * NHP * itemsize) // col_bytes - 2 * H
    if W is None:
        W = max(-(-MP // sms), 2 * H)
        if 2 * H <= w_fit:
            W = min(range(2 * H, w_fit + 1), key=lambda w: (
                -(-(-(-MP // w)) // sms) * (w + 2 * H), -w))
    W = int(W)
    if W < 1:
        raise ValueError(f"W={W} < 1")
    return Geometry(K=K, H=H, W=W, n_tiles=-(-MP // W), smem=W <= w_fit)


def engine_choice(NHP: int, MP: int, dtype, sms: int = SM_COUNT):
    """impl=cuda's and impl=auto's (engine, form) on a card of `sms` SMs,
    in order: B1's resident form ("cuda-b1", "resident") wherever its plan
    holds the state; else this kernel's spill form ("stream", "spill")
    where spill_plan holds it, f32 or f64; else
    its tiling form ("stream", "tiling") for float32 grids whose default
    tiles sit in shared memory with centers of at least 4H columns (halo
    overhead WT/W <= 1.5); else B1's per-half-step form.  At N=100 (NHP=104)
    in f32 the resident plan ends at MP = 132 x 128 = 16,896 columns (bands
    of at most 128 columns in 227 KB); the spill plan holds from there up
    to its L2 budget.  Measured per step on an H100 80GB HBM3 at 700 W, in
    turns (chip_smoke.py's routing phase and python -m
    slb2d_tpu_torch.perf.stream_forms; PERF.md §6): B1's resident form
    faster than the tiling form at N=100 M=4000, N=100 M=12000 and N=400
    M=4000 in f32 (by 1.5x, 1.5x and 2.5x); the spill form faster than
    the tiling form and B1's per-half-step form in f32 at N=100
    M=20000-28000, N=200 M=12000 and N=400 M=6000 (by 1.2-1.8x), and than
    the per-half-step form in f64 at N=100 M=9000, 12000 and 14750 (1.8x,
    2.0x, 1.3x); past the f32 budget it lost at N=400 M=7000; where
    neither plan holds an f32 grid, the earlier measurement stands: the
    tiling form faster than the per-half-step form at W = 4H and 11.5H,
    slower at W = 2.25H."""
    if resident_plan(NHP, MP, dtype, sms) is not None:
        return "cuda-b1", "resident"
    if spill_plan(NHP, MP, dtype, sms) is not None:
        return "stream", "spill"
    if np.dtype(dtype) == np.float32:
        g = default_geometry(NHP, MP, 4, sms=sms)
        if g.smem and g.W >= 4 * g.H:
            return "stream", "tiling"
    return "cuda-b1", "per-half-step"


def stream_beats_b1(NHP: int, MP: int, dtype, sms: int = SM_COUNT) -> bool:
    """Whether engine_choice takes this kernel (either form)."""
    return engine_choice(NHP, MP, dtype, sms)[0] == "stream"


def _tiles(c: stencil.StencilConsts, geom: Geometry, MP: int):
    """The tile batch's constants: (cols, valid) of each local column's
    global column, tile-local StencilConsts (a0, a0_ghost (n_tiles, NHP,
    WT); phi and column masks (n_tiles, 1, WT), False and 0 outside the
    grid), and the center weights w_av, w_av_phi (n_tiles, WT), 0 off the
    tile's own center columns."""
    dev = c.a0.device
    tile = torch.arange(geom.n_tiles, device=dev)[:, None]
    local = torch.arange(geom.WT, device=dev)[None, :]
    cols = tile * geom.W - geom.H + local
    valid = (cols >= 0) & (cols < MP)
    cols = cols.clamp(0, MP - 1)
    center = valid & (local >= geom.H) & (local < geom.H + geom.W)

    def row(v, mask):
        return torch.where(mask, v[cols], torch.zeros((), dtype=v.dtype,
                                                      device=dev))

    tc = dataclasses.replace(
        c, a0=_gather(c.a0, cols, valid), a0_ghost=_gather(c.a0_ghost, cols,
                                                           valid),
        phi=row(c.phi, valid)[:, None, :],
        col_main=row(c.col_main[0], valid)[:, None, :],
        col_half=row(c.col_half[0], valid)[:, None, :],
        col_edge=row(c.col_edge[0], valid)[:, None, :])
    return cols, valid, tc, row(c.w_av, center), row(c.w_av_phi, center)


def _gather(x, cols, valid):
    """(NHP, MP) -> the extended tiles (n_tiles, NHP, WT), 0 outside the
    grid."""
    t = torch.where(valid, x[:, cols], torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return t.permute(1, 0, 2).contiguous()


def _centers(t, geom: Geometry, MP: int):
    """(n_tiles, NHP, WT) -> the (NHP, MP) array of the tiles' centers."""
    cen = t[:, :, geom.H:geom.H + geom.W].permute(1, 0, 2)
    return cen.reshape(t.shape[1], -1)[:, :MP].contiguous()


def _sums(a, b, w_av, w_av_phi):
    """(..., 4) raw sums norm, v_dr, v_y, m_x of main arrays a, b."""
    return torch.stack([
        torch.sum(a[..., 0, :] * w_av, dim=-1),
        torch.sum(b[..., 1, :] * w_av, dim=-1),
        torch.sum(a[..., 0, :] * w_av_phi, dim=-1),
        torch.sum(a[..., 1, :] * w_av, dim=-1)], dim=-1)


def run_chunk_plain_stream(c: stencil.StencilConsts, state: stencil.State,
                           xs, parity0: int, emit_idx, geom: Geometry):
    """The kernel's plain PyTorch version at the same geometry: per launch
    the extended tiles are gathered into an (n_tiles, NHP, WT) batch
    (zeros outside the grid, each tile its own edge chain) and stepped K
    times with stencil.full_step in the reciprocal form, columns wrapping
    within a tile; the centers and the owning tile's edges go back.  The
    per-tile center sums of each step are added in tile order, and the
    av() chain (gated by xs lane 6) and the display-77 records (pre-step
    sums, loop t, post-step av) are replayed from them.  parity0 must be
    state.step % 2.  Returns (state, obs) as run_chunk_plain does."""
    if int(state.step) % 2 != parity0:
        raise ValueError(f"parity0={parity0} disagrees with the state's "
                         f"step count {int(state.step)}")
    n = xs.shape[0]
    NHP, MP = state.a.shape
    dev = state.a.device
    owner = int(c.col_edge[0].nonzero()[0]) // geom.W   # owns column M+1
    cols, valid, tc, w_c, wphi_c = _tiles(c, geom, MP)
    emit = set(int(i) for i in emit_idx)
    a, b, ahs, bhs = state.a, state.b, state.a_hs, state.b_hs
    ea, eb, av = state.hs_edge_a, state.hs_edge_b, state.av
    carry = _sums(a, b, c.w_av, c.w_av_phi)
    records = []
    for s0 in range(0, n, geom.K):
        ns = min(geom.K, n - s0)
        tile = stencil.State(
            a=_gather(a, cols, valid), b=_gather(b, cols, valid),
            a_hs=_gather(ahs, cols, valid), b_hs=_gather(bhs, cols, valid),
            hs_edge_a=ea.expand(geom.n_tiles, NHP),
            hs_edge_b=eb.expand(geom.n_tiles, NHP), av=av, t=state.t,
            step=torch.tensor((parity0 + s0) % 2, dtype=torch.int32,
                              device=dev))
        parts = []
        for s in range(ns):
            trig = tuple(float(v) for v in xs[s0 + s, :6])
            tile = stencil.full_step(tc, tile, trig, False,
                                     use_reciprocal=True)
            parts.append(_sums(tile.a, tile.b, w_c, wphi_c))
        part = torch.stack(parts)                  # (ns, n_tiles, 4)
        tot = part[:, 0]
        for j in range(1, geom.n_tiles):           # tile order
            tot = tot + part[:, j]
        a, b = _centers(tile.a, geom, MP), _centers(tile.b, geom, MP)
        ahs, bhs = _centers(tile.a_hs, geom, MP), _centers(tile.b_hs, geom,
                                                           MP)
        ea, eb = tile.hs_edge_a[owner], tile.hs_edge_b[owner]
        for s in range(ns):
            row = xs[s0 + s]
            if row[6] > 0:
                av = stencil.av_update_from_sums(
                    c, av, tot[s, 1], tot[s, 2], tot[s, 3], float(row[4]),
                    float(row[5]))
            if s0 + s in emit:
                records.append(torch.cat([
                    carry, torch.tensor([row[7]], dtype=av.dtype,
                                        device=dev), av]))
            carry = tot[s]
    obs = None
    if records:
        rec = torch.stack(records)
        obs = torch.zeros((len(records), OBS_LANES), dtype=rec.dtype,
                          device=rec.device)
        obs[:, :rec.shape[1]] = rec
    return stencil.State(a=a, b=b, a_hs=ahs, b_hs=bhs, hs_edge_a=ea,
                         hs_edge_b=eb, av=av, t=state.t,
                         step=state.step + n), obs


class StreamRunner(Runner):
    """The B1 Runner's surface (run_xs, __call__, take_obs, update_consts,
    launches) on this kernel; see the module docstring for which tensors
    change in place.  `form` is "spill" or "tiling": the spill form where
    spill_plan (or the plan given as `spill`) holds the model's shape on
    the consts' device, the tiling form elsewhere, or the form asked for; a
    spill form that cannot hold the shape raises.  `plan` is the spill
    form's SpillPlan (None on the tiling form), `geom` the tiling form's
    Geometry (K and W override default_geometry's)."""

    engine = "stream"

    def __init__(self, c, model, av_enabled=True, exact_trig=False,
                 K=None, W=None, form=None, spill=None):
        self._spill = spill
        self._bufs = None        # see _buffers
        super().__init__(c, model, av_enabled=av_enabled,
                         exact_trig=exact_trig, form=form)
        self.geom = (default_geometry(model.NHP, model.MP,
                                      np.dtype(model.np_dtype).itemsize, K,
                                      W, card_sms(c.a0.device))
                     if self.form == "tiling" else None)

    def _pick_form(self, form, device):
        m = self.model
        plan = self._spill or spill_plan(m.NHP, m.MP, m.np_dtype,
                                         card_sms(device))
        if form is None:
            form = "tiling" if plan is None else "spill"
        if form not in FORMS:
            raise ValueError(f"{self.engine} runner: no form {form!r} (its "
                             f"forms: {', '.join(FORMS)})")
        if form == "spill" and plan is None:
            raise ValueError(
                f"{self.engine} runner: the spill form cannot hold an "
                f"(NHP={m.NHP}, MP={m.MP}) {np.dtype(m.np_dtype).name} "
                f"state (B1's resident form holds it, or no band of "
                f"{card_sms(device)} fits {SMEM_LIMIT} bytes a block with at "
                f"most {MAX_SPILL} spill columns and its slabs in "
                f"{SPILL_L2_BUDGET[np.dtype(m.np_dtype).itemsize]} bytes "
                f"of L2)")
        return form, (plan if form == "spill" else None)

    def _plain(self, state, xs, parity0, emit_idx):
        if self.form == "spill":
            return run_chunk_plain(self.c, state, xs, parity0, emit_idx)
        return run_chunk_plain_stream(self.c, state, xs, parity0, emit_idx,
                                      self.geom)

    def _buffers(self, dev):
        """Device scratch, allocated once per device.  Spill form: the
        exchange buffer (2 step parities x bands x XCH_LANES x NHP), the
        bands' partial sums (2 x bands x PART_LANES) and the slabs.  Tiling
        form: the second buffer set, the scratch (None in shared-memory
        mode), the tile partials and the carry."""
        if self._bufs is None or self._bufs[0].device != dev:
            NHP, MP = self.model.NHP, self.model.MP

            def empty(k):
                return torch.empty(k, dtype=self.dtype, device=dev)
            if self.form == "spill":
                p = self.plan
                self._bufs = (
                    empty(2 * p.bands * XCH_LANES * NHP),
                    empty(2 * p.bands * PART_LANES),
                    empty(p.spill_bytes // np.dtype(self.model.np_dtype)
                          .itemsize))
            else:
                g = self.geom
                self._bufs = (
                    empty(4 * NHP * MP + 2 * NHP),
                    None if g.smem else empty(g.n_tiles * 4 * NHP * g.WT),
                    empty(g.K * g.n_tiles * 4), empty(4))
        return self._bufs

    def _enqueue(self, cdll, tensors, xs_dev, obs, emit, n, parity0,
                 stream):
        m = self.model
        suffix = "_f32" if m.np_dtype == np.float32 else "_f64"
        if self.form == "spill":
            xch, part, slab = self._buffers(xs_dev.device)
            p = self.plan
            rc = getattr(cdll, "slb_stream_spill_chunk" + suffix)(
                *(t.data_ptr() for t in tensors.values()),
                self.params.ctypes.data, xs_dev.data_ptr(), obs.data_ptr(),
                xch.data_ptr(), part.data_ptr(), slab.data_ptr(), m.N, m.M,
                m.NHP, m.MP, p.R, p.bands, int(n), int(parity0), stream)
            return rc, LAUNCHES_PER_CHUNK
        g = self.geom
        alt, scratch, partials, carry = self._buffers(xs_dev.device)
        rc = getattr(cdll, "slb_stream_chunk" + suffix)(
            *(t.data_ptr() for t in tensors.values()),
            self.params.ctypes.data, xs_dev.data_ptr(), obs.data_ptr(),
            alt.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            partials.data_ptr(), carry.data_ptr(), m.N, m.M, m.NHP,
            m.MP, g.K, g.W, g.H, int(n), int(parity0), stream)
        return rc, LAUNCHES_PER_LAUNCH * -(-n // g.K)

    def _add_launches(self, k):
        global launch_count, spill_launch_count, tiling_launch_count
        launch_count += k
        if self.form == "spill":
            spill_launch_count += k
        else:
            tiling_launch_count += k


def make_stream_runner(c: stencil.StencilConsts, model, av_enabled=True,
                       exact_trig=False, K=None, W=None, form=None,
                       spill=None) -> StreamRunner:
    """The B2 runner (see StreamRunner); form forces "spill" or "tiling",
    spill gives the spill form's SpillPlan, K and W override
    default_geometry's choice."""
    return StreamRunner(c, model, av_enabled=av_enabled,
                        exact_trig=exact_trig, K=K, W=W, form=form,
                        spill=spill)
