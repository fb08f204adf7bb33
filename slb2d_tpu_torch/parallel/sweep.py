"""Parameter sweeps on one device: a batch of display-4 runs at once.

The PyTorch counterpart of ``slb2d_tpu/parallel/sweep.py``.  A whole
(E_dc, E_omega, omega, B, mu, alpha) grid becomes a leading point axis of
the state, (B, NHP, MP), where the JAX package vmaps over points.  Each
point reproduces a standalone display-4 run: its own time accumulation,
averaging window [t_start, t_start + T(omega_b)), and loop-exit
instantaneous observables, captured per point at its own t_max crossing
even though all points advance together.

Two engines:
  * the batched torch engine (``_run_sweep``, the vmapped XLA engine's
    counterpart): device trig from each point's carried t; serves
    ``impl=torch`` and float64 under ``impl=auto``;
  * the stacked sweep kernel (``ops/sweep_stack_cuda.py``, kernel B3 on
    CUDA), one launch per chunk for the whole batch: with a shared omega
    from exact host trig tables, every point exiting at the last step;
    with omega swept (per-omega mode) from per-point trig chains, with
    per-point windows and the loop-exit capture (with frames, each
    point's arrays too) rolled in the kernel.  Each point's state sits in
    the shared memory of a thread-block cluster for the whole chunk
    (``cluster_plan``), or, for points no portable cluster holds, streams
    through L2 from one block (the streaming form).

Routing (``choose_engine``) follows the JAX package's _use_stack_engine
with pallas -> cuda, xla -> torch and "the backend is a TPU" -> "the
sweep's device is CUDA", except that omega sweeps, with or without
frames, take the kernel too.  The JAX package sends them to its vmapped
engine (slb2d_tpu/parallel/sweep.py:385-430); on an H100 80GB HBM3 at
700 W the kernel path (its cluster form) ran bench.py's 64-point omega
sweep in 0.225 s and the 16x16 paper map in 0.797 s end to end, against
at least 23.3 s and 19.5 s for the batched engine (PERF.md §6).
``impl=cuda`` never falls back to the batched engine: a CPU device
raises.

A "sweep" mesh (parallel/mesh.py) gives each of its slots a contiguous
block of ceil(B / S) points (the JAX package shards the batch over the
axis, slb2d_tpu/parallel/sweep.py:304-361); each slot runs its block on
its own device with the engine choose_engine picks there, every block for
the whole sweep's step count.  A ragged batch (B % S != 0) leaves the last
slots fewer points, or none, where the JAX package replicates it.  Across
processes every process gets the whole table (its blocks allgathered),
and process 0 alone writes checkpoints and the instability report.

The combined sweep x space layout (``space_axis=``, the sweep CLI's
``shards>1``; slb2d_tpu/parallel/sweep.py:123-167, :448-490): each index
of the mesh's "sweep" axis takes a block of points as above and runs it
on its row of "space" slots (Mesh.grid), each slot holding its (b, NHP,
MP/S) slice of the block's state and of the m-indexed constants
(parallel/spatial.SpaceLayout), on the batched torch engine: the
counterpart of the JAX package's vmapped scan under shard_map, where no
kernel runs either.  The state comes out bit for bit as on one device;
the averages and captures differ by the order of the sums over m (slot
order, the same on one process or several).  Ragged blocks are allowed
(the JAX package wants B % S == 0).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import types

import numpy as np
import torch

from .. import tracing
from ..config import SimConfig, torch_device
from ..constants import PI
from ..models.superlattice import SuperlatticeModel
from ..ops import stencil
from ..ops.stencil import CAP_KEYS, capture_sums
from ..runtime.schedule import count_steps

SWEEPABLE = ("E_dc", "E_omega", "omega", "mu", "alpha", "B")

# per-point StencilConsts fields (the JAX package's in_axes=0 fields)
_POINT_FIELDS = ("E_dc", "E_omega", "omega", "B", "bdt")


def _rank() -> int:
    from .mesh import process_index
    return process_index()


def choose_engine(cfg: SimConfig, device, combined=False) -> str:
    """'cuda' (the stacked sweep kernel) or 'torch' (the batched engine).
    The kernel takes any point size: a point too large for a cluster's
    shared memory runs on its streaming form, so there is no VMEM
    fallback; impl=cuda (and impl=stream, which forces the stacked kernel
    as in the JAX package) on a non-CUDA device raises.  The combined
    sweep x space layout (combined) runs on the batched engine only:
    impl=cuda and impl=stream raise there (the JAX package runs its
    vmapped engine under any impl)."""
    device = torch.device(device)
    if cfg.impl == "torch":
        return "torch"
    if combined:
        if cfg.impl in ("cuda", "stream"):
            raise ValueError(
                f"impl={cfg.impl}: no kernel runs the combined sweep x "
                f"space layout (a sweep with shards>1 or space_axis=); "
                f"use impl=torch|auto")
        return "torch"
    if cfg.impl in ("cuda", "stream"):
        if device.type != "cuda":
            raise ValueError(f"impl={cfg.impl} needs a CUDA device, got "
                             f"{device}")
        return "cuda"
    if device.type != "cuda" or cfg.dtype != "f32":
        return "torch"
    return "cuda"


def _sweep_step(c, st, cap, weights, **hooks):
    """One step of every point plus the loop-exit capture: the JAX
    package's _make_point_step with the point axis written out.  With
    "a", "b" in cap (capture_state) each point's arrays are frozen at its
    own loop exit too.  hooks: full_step's shift and sum_m (the combined
    layout's halo shift and slot-order sum)."""
    t = st.t[:, None, None]
    trig = stencil.device_trig(c, t)
    trig = trig[:4] + tuple(x.reshape(-1) for x in trig[4:])
    # E_omega > 0 gates averaging exactly as the reference
    # (src/boltzmann_c_solver.c:188): a dc-only point leaves all period
    # averages at zero
    do_av = ((c.E_omega > 0) & (t >= c.t_start) & (t < c.t_end)).reshape(-1)
    new = stencil.full_step(c, st, trig, do_av, **hooks)
    # the last step whose loop t is still < t_max overwrites the capture
    # (display-4 inline sums, src/boltzmann_c_solver.c:236-244)
    live = st.t < c.t_end.reshape(-1)
    inst = _capture(new, weights, sum_m=hooks.get("sum_m", stencil._sum_m))
    if "a" in cap:
        inst.update(a=new.a, b=new.b)
    cap = {k: torch.where(live.reshape((-1,) + (1,) * (len(v.shape) - 1)),
                          inst[k], v) for k, v in cap.items()}
    return new, cap


def _capture(st, weights, capture_state=False, sum_m=stencil._sum_m):
    """The display-4 loop-exit capture of every point's current arrays,
    with the arrays themselves when capture_state."""
    sums = capture_sums(st, weights["w_d4"], weights["w_d4_phi"],
                        weights["w_norm"], sum_m)
    cap = dict(zip(CAP_KEYS, sums.unbind(-1)))
    if capture_state:
        cap["a"] = st.a.clone()       # the kernel updates st in place
        cap["b"] = st.b.clone()
    return cap


def _run_sweep(consts, states, cap, weights, n_steps, **hooks):
    """Advance the whole batch n_steps on the batched torch engine and roll
    each point's loop-exit capture."""
    for _ in range(n_steps):
        states, cap = _sweep_step(consts, states, cap, weights, **hooks)
    return states, cap


def _row_groups(rows) -> dict:
    """{row index: process group} for the rows of a combined mesh whose
    slots span more than one process and fewer than all: every process
    creates every such group, in row order, as torch.distributed wants."""
    from .mesh import process_count
    n = process_count()
    groups = {}
    if n == 1:
        return groups
    import torch.distributed as dist
    for i, row in enumerate(rows):
        procs = sorted({s.rank for s in row})
        if 1 < len(procs) < n:
            groups[i] = dist.new_group(procs)
    return groups


class ParameterSweep:
    def __init__(self, cfg: SimConfig, params: dict, device=None,
                 capture_state=False, mesh=None, axis="sweep",
                 space_axis=None, layout=None):
        """params: {name: 1-D array}; all arrays broadcast together into a
        flat batch (numpy meshgrid + ravel upstream for grids).  device:
        the one device of the sweep (default: cuda:<cfg.device> for every
        impl, the CPU for device=cpu).  capture_state: run() also freezes
        each point's (a, b) at its own loop exit, for per-point frames
        (sweep frames-dir=).  mesh, axis: spread the points over the mesh's
        `axis` slots, a block of ceil(B / S) each (device is then the
        first local slot's).  space_axis: the combined layout, each block
        on its row of the mesh's `space_axis` slots (cfg.shards, where
        above 1, must be their count).  layout: one block of the combined
        layout, its points' grids cut over the SpaceLayout's slots (the
        blocks _split makes)."""
        self.run_id = tracing.run_id()
        with tracing.span("sweep.init", run=self.run_id):
            self._setup(cfg, params, device, capture_state, mesh, axis,
                        space_axis, layout)

    def _setup(self, cfg, params, device, capture_state, mesh, axis,
               space_axis, layout):
        for k in params:
            if k not in SWEEPABLE:
                raise ValueError(f"cannot sweep over {k!r}")
        if cfg.shards > 1 and layout is None and (
                mesh is None or space_axis is None
                or mesh.shape.get(space_axis) != cfg.shards):
            raise ValueError(
                f"shards={cfg.shards}: a sweep cuts each point's grid over "
                f"the {cfg.shards} slots of a mesh's space axis (mesh=, "
                f"space_axis=; the sweep CLI builds them)")
        self.cfg = cfg
        arrs = np.broadcast_arrays(*[np.asarray(v, np.float64)
                                     for v in params.values()])
        flat = [np.ravel(np.asarray(a)) for a in arrs]
        self.B = len(flat[0]) if flat else 1
        self.params = dict(zip(params.keys(), flat))
        self.capture_state = capture_state
        self.final_ab = None
        self.mesh = mesh
        self.blocks = None
        self.layout = layout
        if mesh is not None:
            self.rows = (mesh.grid(axis, space_axis) if space_axis
                         else [[s] for s in mesh.axis_slots(axis)])
            self.device = torch.device(next(
                s.device for row in self.rows for s in row
                if s.rank == _rank()))
        elif layout is not None:
            self.device = layout.home
        else:
            self.device = torch_device(cfg, device)

        with tracing.span("sweep.points"):
            t_end = self._points(cfg)
        if mesh is not None:
            self._split(capture_state, space_axis)
            return
        self.engine = choose_engine(cfg, self.device,
                                    combined=layout is not None)
        with tracing.span("sweep.consts"):
            self.consts = self._batched_consts(t_end)
        self._stack_runner = None

    def _points(self, cfg):
        """The per-point models, the shared step count (the longest point's
        loop trip count); returns each point's averaging window end, t_max
        = D(t_start + T_b)."""
        # scalar derivations are cheap; a0 differs only when mu/alpha vary
        self.models = []
        for i in range(self.B):
            kw = {k: float(v[i]) for k, v in self.params.items()}
            self.models.append(SuperlatticeModel(cfg.replace(**kw)))
        m0 = self.base = self.models[0]
        D = m0.np_dtype
        t_end = np.asarray([D(D(cfg.t_start) + m.T) for m in self.models])
        self.n_steps = max(
            count_steps(0.0, float(t_end[i]), float(m0.dt), D)
            for i in range(self.B))
        return t_end

    def _batched_consts(self, t_end):
        """The points' StencilConsts: the first point's, with a leading
        point axis on the fields that vary, built where the points' grids
        live: on the one device, or on the host and cut over the slots (no
        slot's device holds a whole grid)."""
        D = self.base.np_dtype
        home = self.device if self.layout is None else torch.device("cpu")

        def stack(field):
            return torch.as_tensor(
                np.stack([np.asarray(getattr(m, field), D)
                          for m in self.models]), device=home)

        batched = {f: stack(f).reshape(self.B, 1, 1) for f in _POINT_FIELDS}
        if any(k in self.params for k in ("mu", "alpha")):
            batched["a0"] = stack("a0")
            batched["a0_ghost"] = stack("a0_ghost")
        batched["t_end"] = torch.as_tensor(
            t_end, device=home).reshape(self.B, 1, 1)
        consts = dataclasses.replace(
            stencil.consts_from_model(self.base, home), **batched)
        if self.layout is not None:
            consts = self.layout.scatter_consts(consts)
        return consts

    def _split(self, capture_state, space_axis):
        """The mesh's blocks: per index of its sweep axis the points [lo,
        hi), ceil(B / S) in order; for this process's non-empty blocks a
        sweep of their points on the index's slot, or with a space axis on
        its row of slots, run for the whole sweep's step count."""
        S = len(self.rows)
        per = math.ceil(self.B / S)
        self.bounds = [(min(i * per, self.B), min((i + 1) * per, self.B))
                       for i in range(S)]
        groups = _row_groups(self.rows) if space_axis else {}
        self.blocks = []
        for i, row in enumerate(self.rows):
            lo, hi = self.bounds[i]
            if all(s.rank != _rank() for s in row) or lo == hi:
                continue
            sub_params = {k: v[lo:hi] for k, v in self.params.items()}
            if space_axis:
                from .spatial import SpaceLayout
                lay = SpaceLayout(row, self.base.MP, group=groups.get(i))
                sub = ParameterSweep(self.cfg, sub_params,
                                     capture_state=capture_state, layout=lay)
            else:
                sub = ParameterSweep(self.cfg, sub_params,
                                     device=row[0].device,
                                     capture_state=capture_state)
            sub.n_steps = self.n_steps
            self.blocks.append((i, sub))
        engines = sorted({sub.engine for _, sub in self.blocks})
        self.engine = "+".join(engines) if engines else "none"

    # -- device program -------------------------------------------------------

    def _put(self, x, m_indexed=False):
        """A host value on the sweep's device, or on a combined block's
        slots: each slot's slice where m_indexed, else a copy each."""
        if self.layout is None:
            return torch.as_tensor(x, device=self.device)
        return (self.layout.scatter if m_indexed
                else self.layout.replicate)(x)

    def _hooks(self):
        """full_step's shift and sum_m on a combined block, else none."""
        if self.layout is None:
            return {}
        return dict(shift=self.layout.shift, sum_m=self.layout.sum_m)

    def _initial_states(self):
        """Batched bootstrap: a <- a0, b <- 0, one tiptoe half-step over
        the batch (the numerics of stencil.bootstrap_state, reference
        src/boltzmann_c_solver.c:136-145, point by point)."""
        D = self.base.np_dtype
        a = self._put(np.stack([m.initial_a() for m in self.models]), True)
        cos_wdt = self._put(np.array(
            [stencil.bootstrap_cos_wdt(m) for m in self.models],
            D).reshape(self.B, 1, 1))
        a_hs, b_hs = stencil.tiptoe_half_step(
            self.consts, a, cos_wdt, shift=(stencil._shift if self.layout
                                             is None else self.layout.shift))
        return stencil.State(
            a=a, b=torch.zeros_like(a), a_hs=a_hs, b_hs=b_hs,
            **{f: self._put(v) for f, v in stencil.zero_carries(
                (self.B,), self.base.NHP, a.dtype).items()})

    def _weights(self):
        return {k: self._put(getattr(self.base, k), True)
                for k in ("w_d4", "w_d4_phi", "w_norm")}

    def _zero_cap(self):
        dt = self.consts.a0.dtype
        cap = {k: self._put(torch.zeros((self.B,), dtype=dt))
               for k in CAP_KEYS}
        if self.capture_state:
            shape = (self.B, self.base.NHP, self.base.MP)
            cap["a"] = self._put(torch.zeros(shape, dtype=dt), True)
            cap["b"] = self._put(torch.zeros(shape, dtype=dt), True)
        return cap

    def _place(self, states, cap):
        """A host batch's (states, cap) (numpy arrays by field and key) on
        the sweep's device, or cut over a combined block's slots."""
        from .spatial import M_STATE
        st = stencil.State(**{f: self._put(np.array(states[f]),
                                           f in M_STATE)
                              for f in stencil.FIELDS})
        cp = {k: self._put(np.array(v), k in ("a", "b"))
              for k, v in cap.items()}
        return st, cp

    def run(self, checkpoint=None, resume=None, checkpoint_every=0):
        """Run all points to their t_max; returns per-point display-4
        observables as a dict of (B,) arrays.  With capture_state,
        afterwards `self.final_ab` holds host (B, NHP, MP) arrays of each
        point's (a, b) at its own loop exit.

        checkpoint: .npz path saved at the end and (if checkpoint_every >
        0) every checkpoint_every steps, in the JAX package's sweep
        checkpoint layout (either package loads the other's, and any
        layout, one device or a mesh, resumes any other's).  resume:
        continue an interrupted sweep from such a file (the grid must
        match).  On a mesh every block advances chunk by chunk, each
        block's launches enqueued before any block's results are read."""
        with tracing.span("sweep.run", run=self.run_id):
            return self._run(checkpoint, resume, checkpoint_every)

    def _run(self, checkpoint, resume, checkpoint_every):
        checkpoint = checkpoint or None          # '' from the CLI == unset
        resume = resume or None
        self.final_ab = None
        done, saved = 0, None
        if resume is not None:
            *saved, done = self._load_checkpoint(resume)
        parts = ([(0, self.B, self)] if self.blocks is None else
                 [(*self.bounds[i], sub) for i, sub in self.blocks])
        live = []
        for lo, hi, sw in parts:
            with tracing.span("sweep.states"):
                if saved is None:
                    st, cp = sw._initial_states(), sw._zero_cap()
                else:
                    st, cp = sw._place(
                        {k: v[lo:hi] for k, v in saved[0].items()},
                        {k: v[lo:hi] for k, v in saved[1].items()})
                weights = sw._weights()
            live.append([st, cp, sw._advancer(done, weights)])

        chunk = (checkpoint_every if checkpoint and checkpoint_every > 0
                 else self.n_steps - done)
        while done < self.n_steps:
            k = min(chunk, self.n_steps - done)
            for p in live:
                p[0], p[1] = p[2](p[0], p[1], k)
            done += k
            if checkpoint is not None and done < self.n_steps:
                self._save_checkpoint(checkpoint, *self._whole(live), done)
        if checkpoint is not None:
            self._save_checkpoint(checkpoint, *self._whole(live), done)
        states, cap = self._whole(live, full=False)
        if self.capture_state:
            cap = dict(cap)
            with tracing.span("engine.fetch"):
                self.final_ab = (cap.pop("a").cpu().numpy(),
                                 cap.pop("b").cpu().numpy())
        return self._finalize(states, cap)

    def _advancer(self, done, weights):
        """advance(states, cap, k) -> (states, cap) on this sweep's engine,
        from step `done` on; weights: _weights()."""
        if self.engine == "cuda":
            from ..ops.sweep_stack_cuda import SweepStackRunner
            if self._stack_runner is None:
                with tracing.span("engine.build"):
                    self._stack_runner = SweepStackRunner(self)
            runner = self._stack_runner
            runner.seek(done)            # resume-aware t/step trackers
            if runner.per_omega:
                # omega swept: the kernel rolls each point's loop-exit
                # capture (and frames) at its own exit step
                def advance(st, cp, k):
                    with tracing.span("engine.chunk"):
                        return runner.advance(st, k, cap=cp)
            else:
                # a shared omega: every point exits at the last step, so
                # the capture is the post-step sums of the final state
                def advance(st, cp, k):
                    with tracing.span("engine.chunk"):
                        st = runner.advance(st, k)
                    with tracing.span("sweep.capture"):
                        return st, _capture(st, weights, self.capture_state)
            return advance

        hooks = self._hooks()

        def advance(st, cp, k):
            with tracing.span("engine.chunk"):
                return _run_sweep(self.consts, st, cp, weights, k, **hooks)
        return advance

    @tracing.traced("engine.fetch")
    def _host(self, st, cp, full=True):
        """This sweep's (states, cap) as host arrays by field and key; a
        combined block's slices gathered whole (a collective of its
        processes).  full=False: of the states only av."""
        from .spatial import M_STATE
        lay = self.layout

        def host(x, m_indexed):
            if lay is not None:
                x = lay.gather(x) if m_indexed else x.items[0]
            return x.cpu().numpy()
        fields = stencil.FIELDS if full else ("av",)
        d = {f"state_{f}": host(getattr(st, f), f in M_STATE)
             for f in fields}
        d.update({f"cap_{k}": host(v, k in ("a", "b"))
                  for k, v in cp.items()})
        return d

    def _whole(self, live, full=True):
        """(states, cap) of the whole batch from the live (states, cap,
        advance) of this process's blocks: a sweep's own, or on a mesh
        every block's on the host, in order (allgathered across processes;
        a block whose row spans processes comes from the first of
        them).  full=False: of the states only av (the table's)."""
        if self.blocks is None:
            return live[0][0], live[0][1]
        mine = []
        for (st, cp, _), (i, sub) in zip(live, self.blocks):
            d = sub._host(st, cp, full)
            if min(s.rank for s in self.rows[i]) == _rank():
                mine.append((i, d))
        from .collectives import all_gather_object
        mine = sorted(sum(all_gather_object(mine), []), key=lambda x: x[0])
        host = {k: torch.as_tensor(np.concatenate([d[k] for _, d in mine]))
                for k in mine[0][1]}
        cap = {k[len("cap_"):]: v for k, v in host.items()
               if k.startswith("cap_")}
        if not full:
            return types.SimpleNamespace(av=host["state_av"]), cap
        return stencil.State(**{f: host[f"state_{f}"]
                                for f in stencil.FIELDS}), cap

    # -- checkpoint/resume ----------------------------------------------------

    # scalar config a resume must reproduce (swept axes are compared as
    # arrays; these pin the NON-swept remainder and the schedule)
    _CFG_SCALARS = ("E_dc", "E_omega", "omega", "mu", "alpha", "B",
                    "dt", "t_start")

    def _save_checkpoint(self, path, states, cap, done):
        """Atomic .npz snapshot of the whole batch mid-sweep (on a mesh
        gathered by every process; process 0 alone writes it)."""
        if _rank() != 0:
            return
        data = {f"state_{k}": v
                for k, v in stencil.state_to_numpy(states).items()}
        data.update({f"cap_{k}": cap[k].cpu().numpy() for k in cap})
        for k, v in self.params.items():
            data[f"param_{k}"] = v
        for k in self._CFG_SCALARS:
            data[f"cfg_{k}"] = np.float64(getattr(self.cfg, k))
        data["done"] = np.asarray(done)
        data["n_steps"] = np.asarray(self.n_steps)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **data)     # savez keeps an .npz name
        os.replace(tmp, path)

    def _load_checkpoint(self, path):
        z = np.load(path)
        expected_cap = set(CAP_KEYS) | (
            {"a", "b"} if self.capture_state else set())
        saved_cap = {k[len("cap_"):] for k in z.files
                     if k.startswith("cap_")}
        if saved_cap != expected_cap:
            raise ValueError(
                f"sweep checkpoint capture keys {sorted(saved_cap)} do not "
                f"match this run's {sorted(expected_cap)} (frames mode "
                f"mismatch — resume with the same frames-dir setting)")
        if int(z["n_steps"]) != self.n_steps:
            raise ValueError(
                f"sweep checkpoint ran {int(z['n_steps'])} total steps; "
                f"this grid runs {self.n_steps} — t-max/omega/dt must match")
        saved_axes = sorted(k[len("param_"):] for k in z.files
                            if k.startswith("param_"))
        if saved_axes != sorted(self.params):
            raise ValueError(
                f"sweep checkpoint was written by a different grid "
                f"(swept axes {saved_axes} vs {sorted(self.params)})")
        for k, v in self.params.items():
            if not np.array_equal(z[f"param_{k}"], v):
                raise ValueError(
                    f"sweep checkpoint was written by a different grid "
                    f"(axis {k!r} differs)")
        for k in self._CFG_SCALARS:
            if k in self.params:
                continue                      # swept: compared above
            if f"cfg_{k}" in z.files and (
                    float(z[f"cfg_{k}"]) != float(getattr(self.cfg, k))):
                raise ValueError(
                    f"sweep checkpoint was written with {k}="
                    f"{float(z[f'cfg_{k}'])!r}; this run has "
                    f"{float(getattr(self.cfg, k))!r}")
        arrays = {k: z[f"state_{k}"] for k in stencil.FIELDS}
        if arrays["a"].shape != (self.B, self.base.NHP, self.base.MP):
            raise ValueError(
                f"sweep checkpoint shape {arrays['a'].shape} does not match "
                f"(B={self.B}, {self.base.NHP}, {self.base.MP})")
        if arrays["a"].dtype != self.base.np_dtype:
            raise ValueError(
                f"sweep checkpoint dtype {arrays['a'].dtype} does not match "
                f"the dtype= setting ({np.dtype(self.base.np_dtype).name})")
        cap = {k: z[f"cap_{k}"] for k in sorted(expected_cap)}
        return arrays, cap, int(z["done"])

    @tracing.traced("sweep.finalize")
    def _finalize(self, final: stencil.State, cap):
        D = self.base.np_dtype
        with tracing.span("engine.fetch"):
            av = final.av.cpu().numpy()    # (B, 8): av_data[0..5] + Kahan
                                           # compensations in slots 6/7
            out = {k: v.cpu().numpy() for k, v in cap.items()}
        # per-point instability report (the sweep analogue of the
        # single-run NaN guard, runtime/loop.py:_check_finite): a diverged
        # point must not pass silently as NaN rows, but one bad point
        # should not kill the rest of the map either
        bad = ~(np.all(np.isfinite(av), axis=1)
                & np.all([np.isfinite(v) for v in out.values()], axis=0))
        if np.any(bad) and not self.cfg.quiet and _rank() == 0:
            idx = np.flatnonzero(bad)
            vals = {k: np.asarray(v)[idx][:4].tolist()
                    for k, v in self.params.items()}
            print(f"# WARNING: {idx.size} sweep point(s) went non-finite "
                  f"(numerical instability — decrease dt, reference "
                  f"guidance src/boltzmann_c_solver.c:56-57): indices "
                  f"{idx[:8].tolist()} {vals}", file=sys.stderr)
        res = dict(av_count=av[:, 0])
        v_dr_m = np.empty(self.B, D)
        v_y_m = np.empty(self.B, D)
        m_x_m = np.empty(self.B, D)
        T = np.empty(self.B, D)
        for i, m in enumerate(self.models):
            v_dr_m[i] = m.v_dr_multiplier
            v_y_m[i] = m.v_y_multiplier
            m_x_m[i] = m.m_over_multiplier
            T[i] = m.T
        norm_mult = np.asarray(
            [D(2 * PI * np.sqrt(np.float64(m.alpha))) for m in self.models])
        res["v_dr_inst"] = (out["v_dr"] * v_dr_m).astype(D)
        res["v_y_inst"] = (out["v_y"] * v_y_m).astype(D)
        res["m_over_m_x_inst"] = (out["m_x"] * m_x_m).astype(D)
        # astype, not np.float64(): the latter collapses a size-1 batch to
        # a scalar (B=1 sweeps)
        res["norm"] = (out["norm"].astype(np.float64)
                       * norm_mult.astype(np.float64)).astype(D)
        res["v_dr_av"] = (av[:, 1] * v_dr_m).astype(D)
        res["v_y_av"] = (av[:, 2] * v_y_m).astype(D)
        res["m_over_m_x_av"] = (av[:, 3] * m_x_m).astype(D)
        res["A"] = ((av[:, 4] * v_dr_m).astype(D) / T).astype(D)
        res["Asin"] = ((av[:, 5] * v_dr_m).astype(D) / T).astype(D)
        return res
