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
at least 23.3 s and 19.5 s for the batched engine (chip_smoke.py phase
10, PERF.md §6).
``impl=cuda`` never falls back to the batched engine: a CPU device
raises.

Not ported (ROADMAP.md): meshes and ``shards>1`` (queue A item 9).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..config import SimConfig, torch_device
from ..constants import PI
from ..models.superlattice import SuperlatticeModel
from ..ops import stencil
from ..ops.stencil import CAP_KEYS, capture_sums
from ..runtime.schedule import count_steps

SWEEPABLE = ("E_dc", "E_omega", "omega", "mu", "alpha", "B")

# per-point StencilConsts fields (the JAX package's in_axes=0 fields)
_POINT_FIELDS = ("E_dc", "E_omega", "omega", "B", "bdt")


def choose_engine(cfg: SimConfig, device) -> str:
    """'cuda' (the stacked sweep kernel) or 'torch' (the batched engine).
    The kernel takes any point size: a point too large for a cluster's
    shared memory runs on its streaming form, so there is no VMEM
    fallback; impl=cuda (and impl=stream, which forces the stacked kernel
    as in the JAX package) on a non-CUDA device raises."""
    device = torch.device(device)
    if cfg.impl == "torch":
        return "torch"
    if cfg.impl in ("cuda", "stream"):
        if device.type != "cuda":
            raise ValueError(f"impl={cfg.impl} needs a CUDA device, got "
                             f"{device}")
        return "cuda"
    if device.type != "cuda" or cfg.dtype != "f32":
        return "torch"
    return "cuda"


def _sweep_step(c, st, cap, weights):
    """One step of every point plus the loop-exit capture: the JAX
    package's _make_point_step with the point axis written out.  With
    "a", "b" in cap (capture_state) each point's arrays are frozen at its
    own loop exit too."""
    t = st.t[:, None, None]
    trig = stencil.device_trig(c, t)
    trig = trig[:4] + tuple(x.reshape(-1) for x in trig[4:])
    # E_omega > 0 gates averaging exactly as the reference
    # (src/boltzmann_c_solver.c:188): a dc-only point leaves all period
    # averages at zero
    do_av = ((c.E_omega > 0) & (t >= c.t_start) & (t < c.t_end)).reshape(-1)
    new = stencil.full_step(c, st, trig, do_av)
    # the last step whose loop t is still < t_max overwrites the capture
    # (display-4 inline sums, src/boltzmann_c_solver.c:236-244)
    live = st.t < c.t_end.reshape(-1)
    inst = _capture(new, weights)
    if "a" in cap:
        inst.update(a=new.a, b=new.b)
    cap = {k: torch.where(live.reshape((-1,) + (1,) * (v.dim() - 1)),
                          inst[k], v) for k, v in cap.items()}
    return new, cap


def _capture(st, weights, capture_state=False):
    """The display-4 loop-exit capture of every point's current arrays,
    with the arrays themselves when capture_state."""
    sums = capture_sums(st, weights["w_d4"], weights["w_d4_phi"],
                        weights["w_norm"])
    cap = dict(zip(CAP_KEYS, sums.unbind(-1)))
    if capture_state:
        cap["a"] = st.a.clone()       # the kernel updates st in place
        cap["b"] = st.b.clone()
    return cap


def _run_sweep(consts, states, cap, weights, n_steps):
    """Advance the whole batch n_steps on the batched torch engine and roll
    each point's loop-exit capture."""
    for _ in range(n_steps):
        states, cap = _sweep_step(consts, states, cap, weights)
    return states, cap


class ParameterSweep:
    def __init__(self, cfg: SimConfig, params: dict, device=None,
                 capture_state=False):
        """params: {name: 1-D array}; all arrays broadcast together into a
        flat batch (numpy meshgrid + ravel upstream for grids).  device:
        the one device of the sweep (default: cuda:<cfg.device> for every
        impl, the CPU for device=cpu).  capture_state: run() also freezes
        each point's (a, b) at its own loop exit, for per-point frames
        (sweep frames-dir=)."""
        if cfg.shards > 1:
            raise NotImplementedError(
                "slb2d_tpu_torch does not run sweeps with shards>1 yet "
                "(ROADMAP.md queue A item 9)")
        for k in params:
            if k not in SWEEPABLE:
                raise ValueError(f"cannot sweep over {k!r}")
        self.cfg = cfg
        self.device = torch_device(cfg, device)
        arrs = np.broadcast_arrays(*[np.asarray(v, np.float64)
                                     for v in params.values()])
        flat = [np.ravel(np.asarray(a)) for a in arrs]
        self.B = len(flat[0]) if flat else 1
        self.params = dict(zip(params.keys(), flat))
        self.capture_state = capture_state
        self.engine = choose_engine(cfg, self.device)
        self.final_ab = None

        # per-point models: scalar derivations are cheap; a0 differs only
        # when mu/alpha vary
        self.models = []
        for i in range(self.B):
            kw = {k: float(v[i]) for k, v in self.params.items()}
            self.models.append(SuperlatticeModel(cfg.replace(**kw)))
        m0 = self.models[0]
        self.base = m0
        D = m0.np_dtype

        def stack(field):
            return torch.as_tensor(
                np.stack([np.asarray(getattr(m, field), D)
                          for m in self.models]), device=self.device)

        # batched consts: a leading point axis only on fields that vary
        batched = {f: stack(f).reshape(self.B, 1, 1) for f in _POINT_FIELDS}
        if any(k in self.params for k in ("mu", "alpha")):
            batched["a0"] = stack("a0")
            batched["a0_ghost"] = stack("a0_ghost")
        # per-point averaging window end: t_max = D(t_start + T_b)
        t_end = np.asarray([D(D(cfg.t_start) + m.T) for m in self.models])
        batched["t_end"] = torch.as_tensor(
            t_end, device=self.device).reshape(self.B, 1, 1)
        self.consts = dataclasses.replace(
            stencil.consts_from_model(m0, self.device), **batched)
        self._stack_runner = None

        # shared step count: the longest point's loop trip count
        self.n_steps = max(
            count_steps(0.0, float(t_end[i]), float(m0.dt), D)
            for i in range(self.B))

    # -- device program -------------------------------------------------------

    def _initial_states(self):
        """Batched bootstrap: a <- a0, b <- 0, one tiptoe half-step over
        the batch (the numerics of stencil.bootstrap_state, reference
        src/boltzmann_c_solver.c:136-145, point by point)."""
        D = self.base.np_dtype
        dev = self.device
        a = torch.as_tensor(np.stack([m.initial_a() for m in self.models]),
                            device=dev)
        cos_wdt = torch.as_tensor(np.array(
            [stencil.bootstrap_cos_wdt(m) for m in self.models], D),
            device=dev).reshape(self.B, 1, 1)
        a_hs, b_hs = stencil.tiptoe_half_step(self.consts, a, cos_wdt)
        B, NHP = self.B, self.base.NHP
        return stencil.State(
            a=a, b=torch.zeros_like(a), a_hs=a_hs, b_hs=b_hs,
            hs_edge_a=torch.zeros((B, NHP), dtype=a.dtype, device=dev),
            hs_edge_b=torch.zeros((B, NHP), dtype=a.dtype, device=dev),
            av=torch.zeros((B, 8), dtype=a.dtype, device=dev),
            t=torch.zeros((B,), dtype=a.dtype, device=dev),
            step=torch.zeros((B,), dtype=torch.int32, device=dev))

    def _weights(self):
        return {k: torch.as_tensor(getattr(self.base, k), device=self.device)
                for k in ("w_d4", "w_d4_phi", "w_norm")}

    def _zero_cap(self):
        dt, dev = self.consts.a0.dtype, self.device
        cap = {k: torch.zeros((self.B,), dtype=dt, device=dev)
               for k in CAP_KEYS}
        if self.capture_state:
            shape = (self.B, self.base.NHP, self.base.MP)
            cap["a"] = torch.zeros(shape, dtype=dt, device=dev)
            cap["b"] = torch.zeros(shape, dtype=dt, device=dev)
        return cap

    def run(self, checkpoint=None, resume=None, checkpoint_every=0):
        """Run all points to their t_max; returns per-point display-4
        observables as a dict of (B,) arrays.  With capture_state,
        afterwards `self.final_ab` holds host (B, NHP, MP) arrays of each
        point's (a, b) at its own loop exit.

        checkpoint: .npz path saved at the end and (if checkpoint_every >
        0) every checkpoint_every steps, in the JAX package's sweep
        checkpoint layout (either package loads the other's).  resume:
        continue an interrupted sweep from such a file (the grid must
        match)."""
        checkpoint = checkpoint or None          # '' from the CLI == unset
        resume = resume or None
        weights = self._weights()
        self.final_ab = None
        done = 0
        if resume is not None:
            states, cap, done = self._load_checkpoint(resume)
        else:
            cap = self._zero_cap()
            states = self._initial_states()

        if self.engine == "cuda":
            from ..ops.sweep_stack_cuda import SweepStackRunner
            if self._stack_runner is None:
                self._stack_runner = SweepStackRunner(self)
            runner = self._stack_runner
            runner.seek(done)            # resume-aware t/step trackers
            if runner.per_omega:
                # omega swept: the kernel rolls each point's loop-exit
                # capture (and frames) at its own exit step
                def advance(st, cp, k):
                    return runner.advance(st, k, cap=cp)
            else:
                # a shared omega: every point exits at the last step, so
                # the capture is the post-step sums of the final state
                def advance(st, cp, k):
                    st = runner.advance(st, k)
                    return st, _capture(st, weights, self.capture_state)
        else:
            def advance(st, cp, k):
                return _run_sweep(self.consts, st, cp, weights, k)

        chunk = (checkpoint_every if checkpoint and checkpoint_every > 0
                 else self.n_steps - done)
        while done < self.n_steps:
            k = min(chunk, self.n_steps - done)
            states, cap = advance(states, cap, k)
            done += k
            if checkpoint is not None and done < self.n_steps:
                self._save_checkpoint(checkpoint, states, cap, done)
        if checkpoint is not None:
            self._save_checkpoint(checkpoint, states, cap, done)
        if self.capture_state:
            cap = dict(cap)
            self.final_ab = (cap.pop("a").cpu().numpy(),
                             cap.pop("b").cpu().numpy())
        return self._finalize(states, cap)

    # -- checkpoint/resume ----------------------------------------------------

    # scalar config a resume must reproduce (swept axes are compared as
    # arrays; these pin the NON-swept remainder and the schedule)
    _CFG_SCALARS = ("E_dc", "E_omega", "omega", "mu", "alpha", "B",
                    "dt", "t_start")

    def _save_checkpoint(self, path, states, cap, done):
        """Atomic .npz snapshot of the whole batch mid-sweep."""
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
        states = stencil.state_from_numpy(arrays, self.device)
        cap = {k: torch.as_tensor(z[f"cap_{k}"], device=self.device)
               for k in sorted(expected_cap)}
        return states, cap, int(z["done"])

    def _finalize(self, final: stencil.State, cap):
        D = self.base.np_dtype
        av = final.av.cpu().numpy()        # (B, 8): av_data[0..5] + Kahan
                                           # compensations in slots 6/7
        out = {k: v.cpu().numpy() for k, v in cap.items()}
        # per-point instability report (the sweep analogue of the
        # single-run NaN guard, runtime/loop.py:_check_finite): a diverged
        # point must not pass silently as NaN rows, but one bad point
        # should not kill the rest of the map either
        bad = ~(np.all(np.isfinite(av), axis=1)
                & np.all([np.isfinite(v) for v in out.values()], axis=0))
        if np.any(bad) and not self.cfg.quiet:
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
