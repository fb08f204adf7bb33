"""Chunked full-step runner by temporal tiling on the hand-written CUDA
kernel (csrc/stepper_stream.cu): the port of the JAX package's stream
engine (slb2d_tpu/ops/stepper_stream.py:make_stream_runner, kernel B2).

The phi_y axis is cut into tiles of W center columns with an H-column halo
on each side; each launch advances every tile K full steps on its own
(2K <= H keeps the centers exact), and a one-block replay adds the tiles'
per-step center sums in tile order and runs the av() chain and the
display-77 records from them.  A chunk is ceil(n/K) such pairs of launches
from one C call, with no host work per step.

The geometry is chosen for an H100, not copied from the TPU's (W=2048,
H=128, K=64): K=4, H=8, and W such that the tiles fill the card's 132
SMs in one wave; the working tiles live in shared memory where four
(NHP, W+2H) arrays fit in a block's 227 KB, else in a per-block scratch in
global memory (default_geometry).  K=4 was the fastest of K = 2..16 at
N=100 M=4000 and within 2% of the fastest at N=100 M=12000 (H100 80GB
HBM3, 700 W; PERF.md §6).

Contract: on a CUDA device the state's tensors (a, b, a_hs, b_hs, the
edges and av) are updated in place, as the B1 Runner updates them; the
runner keeps a second buffer set that launches ping-pong with, and copies
the result back after an odd number of launches.  On CPU tensors the
runner runs the plain version, ``run_chunk_plain_stream``, which returns
new tensors.  On CUDA tensors it launches the kernel or raises; nothing
falls back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import stencil
from .stepper_cuda import OBS_LANES, Runner, resident_plan

# halo columns per step of a launch (two half-steps of an m±1 stencil)
HALO_PER_STEP = 2
DEFAULT_K = 4
MAX_K = 32                    # the replay kernel's table (REPLAY_BLOCK / 4)
# one wave of one block per SM on an H100 (132 SMs)
TARGET_TILES = 132
# dynamic shared memory a tile may use: 227 KB per block less the block
# sums' static table
SMEM_BUDGET = 225 * 1024

# kernel launches per K steps: the tiles, the replay
LAUNCHES_PER_LAUNCH = 2

# kernel launches made by every stream runner of this process (each runner
# also counts its own in .launches); reset it before a run and read it
# after to show the run went through the kernel
launch_count = 0


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
                     W: int | None = None) -> Geometry:
    """K steps per launch (default 4), H = 2K, and W: given, or enough
    columns for TARGET_TILES tiles but at least 2H (halo overhead at most
    2x) and, in shared memory, at most what fits (four (NHP, W+2H) arrays
    and the edge chain in SMEM_BUDGET).  Tiles go to shared memory when
    they fit, else to global scratch."""
    K = DEFAULT_K if K is None else int(K)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}")
    H = HALO_PER_STEP * K
    col_bytes = 4 * NHP * itemsize
    w_fit = (SMEM_BUDGET - 2 * NHP * itemsize) // col_bytes - 2 * H
    if W is None:
        W = max(-(-MP // TARGET_TILES), 2 * H)
        if 2 * H <= w_fit:
            W = min(W, w_fit)
    W = int(W)
    if W < 1:
        raise ValueError(f"W={W} < 1")
    return Geometry(K=K, H=H, W=W, n_tiles=-(-MP // W), smem=W <= w_fit)


def stream_beats_b1(NHP: int, MP: int, dtype) -> bool:
    """impl=cuda's and impl=auto's engine choice on a card: B1
    (ops/stepper_cuda.py) wherever its resident form holds the state;
    elsewhere this kernel for float32 grids whose default tiles sit in
    shared memory with centers of at least 4H columns (halo overhead WT/W
    <= 1.5), B1's per-half-step form for the rest.  Measured per step in
    f32 on an H100 80GB HBM3 at 700 W, the three engines in turns
    (chip_smoke.py's routing phase; PERF.md §6): B1's resident form faster
    than B2 at N=100 M=4000, N=100 M=12000 and N=400 M=4000 (by 1.5x,
    1.5x and 2.5x); where no resident plan holds an f32 grid (wider than
    ~55,000 columns or taller than ~410 rows), the earlier measurement
    stands: B2 faster than the per-half-step form at W = 4H and 11.5H,
    slower at W = 2.25H.  float64 on B2 was not measured and stays on
    B1."""
    if np.dtype(dtype) != np.float32:
        return False
    if resident_plan(NHP, MP, dtype) is not None:
        return False
    g = default_geometry(NHP, MP, 4)
    return g.smem and g.W >= 4 * g.H


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
    launches) on the temporal-tiling kernel; see the module docstring for
    which tensors change in place."""

    engine = "stream"

    def __init__(self, c, model, av_enabled=True, exact_trig=False,
                 K=None, W=None):
        super().__init__(c, model, av_enabled=av_enabled,
                         exact_trig=exact_trig)
        self.geom = default_geometry(model.NHP, model.MP,
                                     np.dtype(model.np_dtype).itemsize, K, W)
        self._bufs = None        # see _buffers

    def _pick_form(self, form, device):
        """B2 has one form (no `form`, no `plan`)."""
        if form is not None:
            raise ValueError(f"{self.engine} runner: no form {form!r}")
        return None, None

    def _plain(self, state, xs, parity0, emit_idx):
        return run_chunk_plain_stream(self.c, state, xs, parity0, emit_idx,
                                      self.geom)

    def _buffers(self, dev):
        """The second buffer set, the scratch (None in shared-memory
        mode), the tile partials and the carry, allocated once."""
        if self._bufs is None or self._bufs[0].device != dev:
            NHP, MP, g = self.model.NHP, self.model.MP, self.geom

            def empty(k):
                return torch.empty(k, dtype=self.dtype, device=dev)
            self._bufs = (
                empty(4 * NHP * MP + 2 * NHP),
                None if g.smem else empty(g.n_tiles * 4 * NHP * g.WT),
                empty(g.K * g.n_tiles * 4), empty(4))
        return self._bufs

    def _enqueue(self, cdll, tensors, xs_dev, obs, emit, n, parity0,
                 stream):
        m, g = self.model, self.geom
        fn = (cdll.slb_stream_chunk_f32 if m.np_dtype == np.float32
              else cdll.slb_stream_chunk_f64)
        alt, scratch, partials, carry = self._buffers(xs_dev.device)
        rc = fn(*(t.data_ptr() for t in tensors.values()),
                self.params.ctypes.data, xs_dev.data_ptr(), obs.data_ptr(),
                alt.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                partials.data_ptr(), carry.data_ptr(), m.N, m.M, m.NHP,
                m.MP, g.K, g.W, g.H, int(n), int(parity0), stream)
        return rc, LAUNCHES_PER_LAUNCH * -(-n // g.K)

    @staticmethod
    def _add_launches(k):
        global launch_count
        launch_count += k


def make_stream_runner(c: stencil.StencilConsts, model, av_enabled=True,
                       exact_trig=False, K=None, W=None) -> StreamRunner:
    """The B2 runner; K and W override default_geometry's choice."""
    return StreamRunner(c, model, av_enabled=av_enabled,
                        exact_trig=exact_trig, K=K, W=W)
