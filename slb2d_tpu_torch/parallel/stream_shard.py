"""The sharded form of B2: the tiling form of csrc/stepper_stream.cu over
each shard of a phi_y grid cut over the "space" axis (impl=stream, cuda
and auto with shards>1).

The port of the JAX package's make_sharded_stream_runner
(slb2d_tpu/ops/stepper_stream.py), which runs each shard's extended slice
(its columns and 128 halo columns a side) as one tile a launch.  Here each
shard's extended slice (L = MP / S columns and H a side) is cut into
tiles as default_geometry cuts a grid of L columns (K steps a launch,
H = 2K), so a shard's tiles spread over the card's SMs.  Per round of K
steps: the halo columns come from the neighbours (SpaceLayout.fill_halos;
zeros past the grid's ends, as the unsharded tiles read them), the shards
whose slices cover column M+1 take its owner's edge chain, one tile
launch per shard, then one replay launch on the home device over every
shard's tile sums, added shard by shard and tile by tile.  The state
and its edges come out bit for bit as the unsharded tiling form's; av and
the display-77 records differ only by the order of the sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..ops import stencil
from ..ops.stepper_cuda import (OBS_LANES, SCALAR_FIELDS, card_sms,
                                pack_xs_dict)
from ..ops.stepper_stream_cuda import (DEFAULT_K, HALO_PER_STEP, Geometry,
                                       add_in_order, default_geometry,
                                       obs_table, plain_launch, raw_sums,
                                       replay_sums, tile_consts)
from .spatial import M_FIELDS, M_STATE, Slots

def validate_shard_geometry(NHP: int, MP: int, S: int, K: int | None = None):
    """Raise where the sharded form cannot run S shards of an (NHP, MP)
    grid: MP not a multiple of S (the JAX driver's message), or a shard
    narrower than 2H columns, whose neighbours' halos would then reach
    past the next shard.  The JAX package's check is its own (slices of
    128-column multiples in its VMEM budget, f32 only)."""
    if MP % S:
        raise ValueError(
            f"shards={S} does not divide the padded grid MP={MP}; pick a "
            f"shard count dividing it (g-grid pads M+3 up to a multiple "
            f"of 128)")
    H = HALO_PER_STEP * (DEFAULT_K if K is None else int(K))
    if MP // S < 2 * H:
        raise ValueError(
            f"shards={S} leaves {MP // S} columns a shard of MP={MP}, fewer "
            f"than the sharded stream form's 2H={2 * H}; lower shards=")


def edge_shards(layout, m1: int, H: int):
    """(the shard whose columns hold column m1 = M+1 and whose tile owning
    it writes the edge chain out, the other shards whose extended slices
    cover it: their tiles keep the chain too, from the owner's edges)."""
    L = layout.L
    owner = m1 // L
    return owner, [i for i in range(layout.S) if i != owner
                   and i * L - H <= m1 < (i + 1) * L + H]


def _slot_sums(layout, state, w_av, w_av_phi):
    """The four raw sums (norm, v_dr, v_y, m_x) of a sharded state's main
    arrays, each slot's added in slot order, on the home device."""
    parts = Slots(raw_sums(a, b, w, wp) for a, b, w, wp in zip(
        state.a.items, state.b.items, w_av.items, w_av_phi.items))
    return layout.sum_m(parts.unsqueeze(-1)).items[0]


def run_chunk_plain_stream_sharded(c: stencil.StencilConsts, state, xs,
                                   parity0: int, emit_idx, geom: Geometry,
                                   layout):
    """The sharded form's plain PyTorch version, as the kernel computes it.
    state: a sharded State (parallel/spatial.py: Slots, each slot its
    (NHP, L) slice, the rest replicated); c: the whole grid's consts.  Per
    launch round every shard's extended slice (L + 2H columns) takes its
    neighbours' H edge columns (zeros past the grid's ends), the shards
    that cover column M+1 take its owner's edges, and each shard's tiles
    (geom, cut over its own L columns) go through the unsharded plain
    version's launch (stepper_stream_cuda.plain_launch); their centres go
    back and the owner's tile that holds M+1 gives the edges.  Every
    shard's per-tile sums of each step, shard by shard and tile by tile,
    are added in that order, and the av() chain and the display-77 records
    are replayed from them, from the pre-step sums of the incoming state
    (each shard's added in slot order).  Returns (state, obs) as
    run_chunk_plain_stream does; obs and the replicated fields are the
    same on every process."""
    n = xs.shape[0]
    step0 = int(state.step.items[0])
    if step0 % 2 != parity0:
        raise ValueError(f"parity0={parity0} disagrees with the state's "
                         f"step count {step0}")
    MP, L, H, S = layout.MP, layout.L, geom.H, layout.S
    WE = L + 2 * H
    M1 = int(c.col_edge[0].nonzero()[0])
    owner, readers = edge_shards(layout, M1, H)
    owner_tile = (M1 - owner * L) // geom.W
    tiles = []
    for i in layout.local:
        cols, valid, tc, w_c, wphi_c = tile_consts(c, geom, MP, first=i * L,
                                                   own=L)
        idx = (cols - i * L + H).clamp(0, WE - 1)
        tiles.append((idx, valid, tc, w_c, wphi_c))
    emit = set(int(i) for i in emit_idx)
    quad = Slots(torch.stack(v) for v in zip(
        state.a.items, state.b.items, state.a_hs.items, state.b_hs.items))
    edges = Slots(torch.stack(v) for v in zip(state.hs_edge_a.items,
                                               state.hs_edge_b.items))
    av, t = state.av.items[0], state.t.items[0]
    carry = _slot_sums(layout, state, layout.scatter(c.w_av),
                       layout.scatter(c.w_av_phi))
    records = []
    for s0 in range(0, n, geom.K):
        ext = Slots(torch.nn.functional.pad(q, (H, H)) for q in quad.items)
        layout.fill_halos(ext, H)
        layout.send(edges, owner, readers)
        new_quad, new_edges, parts = [], [], []
        for sh, e, q in zip(tiles, edges.items, ext.items):
            centres, (ea, eb), part = plain_launch(
                sh, geom, q, e[0], e[1], av, t, xs, s0, (parity0 + s0) % 2,
                L)
            parts.append(part)                     # (ns, n_tiles, 4)
            new_quad.append(torch.stack(centres))
            new_edges.append(torch.stack([ea[owner_tile], eb[owner_tile]]))
        quad, edges = Slots(new_quad), Slots(new_edges)
        tot = add_in_order(torch.cat(layout.gather_slots(parts), dim=1))
        av, carry = replay_sums(c, av, carry, tot, xs, s0, emit, records)
    layout.send(edges, owner, range(S))
    out = stencil.State(
        a=quad[0], b=quad[1], a_hs=quad[2], b_hs=quad[3],
        hs_edge_a=edges[0], hs_edge_b=edges[1],
        av=layout.replicate(av), t=state.t, step=state.step + n)
    return out, obs_table(records)


class ShardedStreamRunner:
    """The sharded form of B2 (the JAX package's
    make_sharded_stream_runner) over a SpaceLayout: run_xs, take_obs,
    update_consts and launches, as the other runners, on a sharded State
    (parallel/spatial.py).  Each shard runs the tiling form over its
    extended slice, its tiles cut over its own L columns as
    default_geometry cuts a grid of L columns (K steps a launch, H = 2K);
    before every round the halo columns come from the neighbours
    (collectives.exchange) and the shards whose slices cover column M+1
    take its owner's edges.  Per round: one tile launch per shard, then
    one replay launch on the home device over every shard's tile sums.

    cs: the run's sharded consts (SpaceLayout.scatter_consts); no
    constant of the whole grid is kept on a device.  On a card each slot
    keeps two extended buffer sets that rounds ping-pong between, and
    windowed constants cut from the model's host arrays: a0, a0_ghost and
    phi over its extended slice (0 off the grid), w_av and w_av_phi 0 in
    the halo copies, so that every column counts once.  The state's
    slices, edges and av are copied in at a chunk's start and back at its
    end.  On the CPU it runs run_chunk_plain_stream_sharded on the whole
    grid's consts, built on the host for each chunk.  A geometry the form
    cannot run raises (validate_shard_geometry)."""

    engine = "stream"
    form = "sharded"

    def __init__(self, cs: stencil.StencilConsts, model, layout, K=None,
                 W=None):
        validate_shard_geometry(model.NHP, model.MP, layout.S, K)
        self.model, self.layout = model, layout
        self.dtype = (torch.float32 if model.np_dtype == np.float32
                      else torch.float64)
        self.geom = default_geometry(model.NHP, layout.L,
                                     np.dtype(model.np_dtype).itemsize, K,
                                     W, card_sms(layout.home))
        self.owner, self.readers = edge_shards(layout, model.M + 1,
                                               self.geom.H)
        self.launches = 0
        self.last_obs = None
        self._bufs = None
        self._keep = None        # the last chunk's tables, kept alive
        self.update_consts(cs)

    def update_consts(self, cs_new):
        """The run's new sharded consts (their scalars: the parameter
        server's mutations; the m-indexed fields stay the startup ones)."""
        D = self.model.np_dtype
        self.cs = cs_new
        self.params = np.zeros(16, D)
        for i, name in enumerate(SCALAR_FIELDS):
            self.params[i] = D(float(getattr(cs_new, name).items[0]))
        self.dt = self.params[SCALAR_FIELDS.index("dt")]

    def _host_consts(self):
        """The whole grid's consts on the host, for the plain version: the
        model's m-indexed arrays, every other field the run's."""
        return dataclasses.replace(
            stencil.consts_from_model(self.model, "cpu"),
            **{f.name: getattr(self.cs, f.name).items[0].cpu()
               for f in dataclasses.fields(self.cs)
               if f.name not in M_FIELDS})

    def run_xs(self, state, xs_dict, parity0, emit_idx=()):
        n = len(xs_dict["t"])
        xs = pack_xs_dict(xs_dict, self.model.np_dtype)
        dev = self.layout.home
        if dev.type == "cpu":
            out, self.last_obs = run_chunk_plain_stream_sharded(
                self._host_consts(), state, xs, parity0, emit_idx,
                self.geom, self.layout)
        elif dev.type == "cuda":
            out = self._launch(state, xs, n, parity0, emit_idx)
        else:
            raise ValueError(f"sharded stream runner: unsupported device "
                             f"{dev}")
        t_next = self.model.np_dtype(xs[n - 1, 7] + self.dt)
        # copies from host memory that wait for the chunk's kernels to end
        with tracing.span("engine.fetch"):
            t = self.layout.replicate(torch.tensor(t_next, dtype=self.dtype))
        return out.replace(t=t)

    def take_obs(self, n_emit):
        return self.last_obs[:n_emit, :13].cpu().numpy()

    def _buffers(self):
        """Per local slot: the two extended buffer sets (2, 4, NHP, WE), the
        two edge pairs (2, 2, NHP), the tile scratch (None in shared-memory
        mode), its device's table of tile sums (K, S * n_tiles, 4), which
        its tiles write at their columns, and the windowed constants; the
        carry (4,) on the home device.  Allocated once."""
        if self._bufs is None:
            lay, g, m = self.layout, self.geom, self.model
            L, H = lay.L, g.H
            WE = L + 2 * H
            T_all = lay.S * g.n_tiles
            z = torch.zeros((), dtype=self.dtype)
            partials = {d: torch.zeros((g.K, T_all, 4), dtype=self.dtype,
                                       device=d) for d in set(lay.devices)}
            slots = []
            for i, dev in zip(lay.local, lay.devices):
                cols = torch.arange(i * L - H, i * L + L + H)
                valid = (cols >= 0) & (cols < m.MP)
                own = (cols >= i * L) & (cols < (i + 1) * L)
                cc = cols.clamp(0, m.MP - 1)

                def win(name, keep):
                    x = torch.as_tensor(np.asarray(getattr(m, name)))
                    return torch.where(keep, x[..., cc], z).to(
                        dev).contiguous()
                slots.append(dict(
                    ext=torch.zeros((2, 4, m.NHP, WE), dtype=self.dtype,
                                    device=dev),
                    edges=torch.zeros((2, 2, m.NHP), dtype=self.dtype,
                                      device=dev),
                    scratch=(None if g.smem else torch.empty(
                        g.n_tiles * 4 * m.NHP * g.WT, dtype=self.dtype,
                        device=dev)),
                    partials=partials[dev],
                    a0=win("a0", valid), a0_ghost=win("a0_ghost", valid),
                    phi=win("phi", valid), w_av=win("w_av", own),
                    w_av_phi=win("w_av_phi", own)))
            self._bufs = (slots, torch.zeros(4, dtype=self.dtype,
                                             device=lay.home))
        return self._bufs

    def _count(self, tiles: int, replays: int):
        """Add launches made to the runner's count and to the process's
        counters launches.B2.sharded_tiles (one a shard a round) and
        launches.B2.sharded_replays (one a round)."""
        self.launches += tiles + replays
        tracing.count("launches.B2.sharded_tiles", tiles)
        tracing.count("launches.B2.sharded_replays", replays)

    def _launch(self, state, xs, n, parity0, emit_idx):
        """Copy the state in, enqueue every round (halo exchange, one tile
        launch per shard, the tile sums onto the home device, one replay)
        without synchronising, copy the state out."""
        from ..ops import _build
        lay, g, m = self.layout, self.geom, self.model
        L, H = lay.L, g.H
        emit = np.ascontiguousarray(emit_idx, np.int32)
        table = np.array(xs[:n], m.np_dtype)
        table[:, 8] = 0
        table[emit, 8] = 1
        table[emit, 9] = np.arange(emit.size)
        slots, carry = self._buffers()
        cdll = _build.load().cdll
        suffix = "_f32" if self.dtype == torch.float32 else "_f64"
        tiles_fn = getattr(cdll, "slb_stream_shard_tiles" + suffix)
        replay_fn = getattr(cdll, "slb_stream_replay" + suffix)
        item = table.itemsize * table.shape[1]
        tables = {d: torch.from_numpy(table).to(d) for d in
                  set(lay.devices)}
        home = lay.home
        obs = torch.zeros((max(1, emit.size), OBS_LANES), dtype=self.dtype,
                          device=home)
        av = state.av.items[0].clone()
        carry.copy_(_slot_sums(lay, state, self.cs.w_av, self.cs.w_av_phi))
        for k, sl in enumerate(slots):
            for j, f in enumerate(M_STATE):
                sl["ext"][0, j, :, H:H + L].copy_(getattr(state, f).items[k])
            sl["edges"][0, 0].copy_(state.hs_edge_a.items[k])
            sl["edges"][0, 1].copy_(state.hs_edge_b.items[k])
        home_parts = slots[0]["partials"]
        single = (len(set(lay.devices)) == 1 and len(lay.n_per_rank) == 1)
        cur = 0
        for s0 in range(0, n, g.K):
            ns = min(g.K, n - s0)
            ext = Slots(sl["ext"][cur] for sl in slots)
            lay.fill_halos(ext, H)
            lay.send(Slots(sl["edges"][cur] for sl in slots), self.owner,
                     self.readers)
            for i, dev, sl in zip(lay.local, lay.devices, slots):
                src, dst = sl["ext"][cur], sl["ext"][1 - cur]
                es, ed = sl["edges"][cur], sl["edges"][1 - cur]
                with torch.cuda.device(dev):
                    rc = tiles_fn(
                        *(t.data_ptr() for t in (*src, *es, *dst, *ed)),
                        None if sl["scratch"] is None
                        else sl["scratch"].data_ptr(),
                        sl["a0"].data_ptr(), sl["a0_ghost"].data_ptr(),
                        sl["phi"].data_ptr(), sl["w_av"].data_ptr(),
                        sl["w_av_phi"].data_ptr(), self.params.ctypes.data,
                        tables[dev].data_ptr() + s0 * item,
                        sl["partials"].data_ptr(), m.N, m.M, m.NHP, m.MP,
                        L + 2 * H, i * L - H, H, H + L, g.W, H, ns,
                        (parity0 + s0) % 2, i * g.n_tiles,
                        lay.S * g.n_tiles,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"sharded stream tile launch (shard "
                                       f"{i}) failed: cudaError_t {rc}")
                self._count(1, 0)
            if not single:
                blocks = [sl["partials"][:ns, i * g.n_tiles:
                                         (i + 1) * g.n_tiles]
                          for i, sl in zip(lay.local, slots)]
                home_parts[:ns] = torch.cat(lay.gather_slots(blocks),
                                            dim=1)
            with torch.cuda.device(home):
                rc = replay_fn(home_parts.data_ptr(),
                               tables[home].data_ptr() + s0 * item,
                               self.params.ctypes.data, av.data_ptr(),
                               carry.data_ptr(), obs.data_ptr(),
                               lay.S * g.n_tiles, ns,
                               torch.cuda.current_stream(home).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"sharded stream replay failed: "
                                   f"cudaError_t {rc}")
            self._count(0, 1)
            cur = 1 - cur
        edges = Slots(sl["edges"][cur] for sl in slots)
        lay.send(edges, self.owner, range(lay.S))
        for k, sl in enumerate(slots):
            for j, f in enumerate(M_STATE):
                getattr(state, f).items[k].copy_(sl["ext"][cur, j, :,
                                                           H:H + L])
            state.hs_edge_a.items[k].copy_(sl["edges"][cur, 0])
            state.hs_edge_b.items[k].copy_(sl["edges"][cur, 1])
        self._keep = (tables, obs)
        self.last_obs = obs
        return state.replace(av=lay.replicate(av), step=state.step + n)
