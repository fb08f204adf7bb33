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
    ``impl=torch`` and omega sweeps;
  * the stacked sweep kernel (``ops/sweep_stack_cuda.py``, B3's
    shared-omega mode on CUDA): exact host trig tables, one launch per
    chunk for the whole batch; serves float32 sweeps with a shared omega
    on a CUDA device.

Not ported (ROADMAP.md): meshes and ``shards>1`` (queue A item 9), the
per-point frame capture behind ``frames-dir=`` (queue A item 5), and B3's
per-omega mode (queue B).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..config import SimConfig
from ..constants import PI
from ..models.superlattice import SuperlatticeModel
from ..ops import stencil
from ..runtime.schedule import count_steps

SWEEPABLE = ("E_dc", "E_omega", "omega", "mu", "alpha", "B")

# impl=auto routing of omega sweeps to the sweep kernel's per-omega mode:
# off, as in the JAX package (slb2d_tpu/parallel/sweep.py:38), and that
# mode is not ported yet (ROADMAP.md queue B)
PER_OMEGA_AUTO = False

CAP_KEYS = ("v_dr", "v_y", "m_x", "norm")

# per-point StencilConsts fields (the JAX package's in_axes=0 fields)
_POINT_FIELDS = ("E_dc", "E_omega", "omega", "B", "bdt")


def choose_engine(cfg: SimConfig, params, device) -> str:
    """'cuda' (the stacked sweep kernel) or 'torch' (the batched engine),
    as ``slb2d_tpu`` ParameterSweep._use_stack_engine routes with
    pallas -> cuda, xla -> torch and "the backend is a TPU" -> "the
    sweep's device is CUDA".  One point per block has no size bound, so
    there is no VMEM fallback.  impl=cuda never falls back: omega swept
    or a non-CUDA device raises."""
    device = torch.device(device)
    omega = "omega" in params
    if cfg.impl == "torch":
        return "torch"
    if cfg.impl == "cuda":
        if omega:
            raise NotImplementedError(
                "impl=cuda with omega swept needs the sweep kernel's "
                "per-omega mode (B3, ROADMAP.md queue B); impl=auto or "
                "impl=torch run omega sweeps on the batched engine")
        if device.type != "cuda":
            raise ValueError(f"impl=cuda needs a CUDA device, got {device}")
        return "cuda"
    if device.type != "cuda" or cfg.dtype != "f32":
        return "torch"
    if omega and not PER_OMEGA_AUTO:
        return "torch"
    return "cuda"


def _sweep_step(c, st, cap, weights):
    """One step of every point plus the loop-exit capture: the JAX
    package's _make_point_step with the point axis written out."""
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
    cap = {k: torch.where(live, inst[k], cap[k]) for k in CAP_KEYS}
    return new, cap


def _capture(st, weights):
    """The display-4 loop-exit sums of every point's current arrays."""
    return dict(
        v_dr=torch.sum(st.b[:, 1] * weights["w_d4"], dim=-1),
        v_y=torch.sum(st.a[:, 0] * weights["w_d4_phi"], dim=-1),
        m_x=torch.sum(st.a[:, 1] * weights["w_d4"], dim=-1),
        norm=torch.sum(st.a[:, 0] * weights["w_norm"], dim=-1))


def _run_sweep(consts, states, cap, weights, n_steps):
    """Advance the whole batch n_steps on the batched torch engine and roll
    each point's loop-exit capture."""
    for _ in range(n_steps):
        states, cap = _sweep_step(consts, states, cap, weights)
    return states, cap


class ParameterSweep:
    def __init__(self, cfg: SimConfig, params: dict, device=None):
        """params: {name: 1-D array}; all arrays broadcast together into a
        flat batch (numpy meshgrid + ravel upstream for grids).  device:
        the one device of the sweep (default: cuda:<cfg.device> for
        impl=auto|cuda, else the CPU)."""
        if cfg.shards > 1:
            raise NotImplementedError(
                "slb2d_tpu_torch does not run sweeps with shards>1 yet "
                "(ROADMAP.md queue A item 9)")
        for k in params:
            if k not in SWEEPABLE:
                raise ValueError(f"cannot sweep over {k!r}")
        self.cfg = cfg
        if device is None:
            device = (f"cuda:{cfg.device}" if cfg.impl in ("auto", "cuda")
                      else "cpu")
        self.device = torch.device(device)
        arrs = np.broadcast_arrays(*[np.asarray(v, np.float64)
                                     for v in params.values()])
        flat = [np.ravel(np.asarray(a)) for a in arrs]
        self.B = len(flat[0]) if flat else 1
        self.params = dict(zip(params.keys(), flat))
        self.engine = choose_engine(cfg, self.params, self.device)

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

    def run(self, checkpoint=None, resume=None, checkpoint_every=0):
        """Run all points to their t_max; returns per-point display-4
        observables as a dict of (B,) arrays.

        checkpoint: .npz path saved at the end and (if checkpoint_every >
        0) every checkpoint_every steps, in the JAX package's sweep
        checkpoint layout (either package loads the other's).  resume:
        continue an interrupted sweep from such a file (the grid must
        match)."""
        checkpoint = checkpoint or None          # '' from the CLI == unset
        resume = resume or None
        weights = self._weights()
        done = 0
        if resume is not None:
            states, cap, done = self._load_checkpoint(resume)
        else:
            cap = {k: torch.zeros((self.B,), dtype=self.consts.a0.dtype,
                                  device=self.device) for k in CAP_KEYS}
            states = self._initial_states()

        if self.engine == "cuda":
            # the stacked sweep kernel: with a shared omega every point
            # exits at the same step, so the loop-exit capture is the
            # post-step sums of the final state
            from ..ops.sweep_stack_cuda import SweepStackRunner
            if self._stack_runner is None:
                self._stack_runner = SweepStackRunner(self)
            runner = self._stack_runner
            runner.seek(done)            # resume-aware t/step trackers

            def advance(st, cp, k):
                st = runner.advance(st, k)
                return st, _capture(st, weights)
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
        saved_cap = {k[len("cap_"):] for k in z.files
                     if k.startswith("cap_")}
        if saved_cap != set(CAP_KEYS):
            raise ValueError(
                f"sweep checkpoint capture keys {sorted(saved_cap)} do not "
                f"match this run's {sorted(CAP_KEYS)} (frames mode "
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
               for k in CAP_KEYS}
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
