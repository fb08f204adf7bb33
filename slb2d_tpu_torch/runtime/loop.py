"""The simulation driver: chunked time loop over the host step schedule.

The PyTorch counterpart of ``slb2d_tpu/runtime/loop.py`` for one process
on one explicit device.  The hot loop runs host-precomputed step
schedules (runtime/schedule.py) chunk by chunk; the device is
synchronised only at chunk and round boundaries, never per step.

Ported: display 4 and ``checkpoint=``.  Not yet ported (they raise
NotImplementedError and are listed in ROADMAP.md queue A item 3, or item
9 for ``shards``): displays 3/7/8/9/77, the stdin parameter server,
``resume=``, ``warmup`` and ``exact-time=0`` on ``impl=torch``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import config as cfgmod
from ..config import SimConfig  # noqa: F401  (public API)
from ..models.superlattice import SuperlatticeModel
from ..ops import stencil
from ..io import writers
from . import schedule
from .checkpoint import save_state


# Schedule chunk for impl=cuda.  Each chunk costs one synchronising host
# copy of its xs table and a drained launch queue: 0.11-0.17 ms per
# extra chunk against 15 us per step at BASELINE #4 f32 (H100 80GB HBM3,
# 700 W; PERF.md "Chunk length").  16384 steps keep that under 0.1% and
# the host table at 16384 x 10 values; a BASELINE #4 run is one chunk.
CUDA_CHUNK_DEFAULT = 16384

# impl=torch runs a Python loop per step; the chunk only bounds the xs
# slices (the JAX package's XLA-scan default)
TORCH_CHUNK_DEFAULT = 4096


class NumericalInstability(RuntimeError):
    pass


def _unported(cfg: SimConfig):
    """The first feature of cfg this package does not run yet, or None."""
    if cfg.display != 4:
        return f"display={cfg.display} (ROADMAP.md queue A item 3)"
    if cfg.read_from == "stdin":
        return "read-from=stdin (ROADMAP.md queue A item 3)"
    if cfg.resume:
        return "resume= (ROADMAP.md queue A item 3)"
    if cfg.warmup:
        return "warmup (ROADMAP.md queue A item 3)"
    if cfg.shards > 1:
        return "shards>1 (ROADMAP.md queue A item 9)"
    if cfg.impl == "torch" and not cfg.exact_time:
        return "exact-time=0 with impl=torch (ROADMAP.md queue A item 3)"
    return None


class Simulation:
    def __init__(self, cfg: SimConfig, out=None, device=None):
        missing = _unported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"slb2d_tpu_torch does not run {missing} yet")
        self.cfg = cfg
        if device is None:
            device = (f"cuda:{cfg.device}" if cfg.impl in ("auto", "cuda")
                      else "cpu")
        self.device = torch.device(device)
        self._build_model()
        self.out = out if out is not None else cfgmod.open_out(cfg)
        self.quiet = cfg.quiet
        self.frame_time = 0.0
        self.last_rem = 0.0
        self.t_exit = 0.0
        self._steps_since_progress = 0
        self.state = stencil.bootstrap_state(self.c, self.model)
        self.t0 = 0.0
        self.steps_done = 0
        self.t_start = float(cfg.t_start)
        self.t_max = self._compute_t_max()

    # -- setup ---------------------------------------------------------------

    def _build_model(self):
        self.model = SuperlatticeModel(self.cfg)
        self.impl = self._select_impl()
        self.c = stencil.consts_from_model(self.model, self.device)
        self._runner = None

    def _select_impl(self):
        impl = "cuda" if self.cfg.impl == "auto" else self.cfg.impl
        if impl == "cuda":
            # no fallback: the kernel path runs on a card or not at all
            if self.device.type != "cuda":
                raise ValueError(f"impl=cuda needs a CUDA device, got "
                                 f"{self.device}")
            if not torch.cuda.is_available():
                raise RuntimeError("impl=cuda: no CUDA device is available")
        return impl

    def _cuda_runner(self):
        if self._runner is None:
            from ..ops.stepper_cuda import make_cuda_runner
            self._runner = make_cuda_runner(self.c, self.model)
        return self._runner

    def _compute_t_max(self):
        D = self.model.np_dtype
        return float(D(D(self.t_start) + self.model.T))

    # -- main ----------------------------------------------------------------

    def run(self):
        """One display-4 round; returns the final State."""
        cfg = self.cfg
        if not self.quiet:
            print(f"# t_max = {writers.f20(self.model.np_dtype(self.t_max))}")
        wall_t0 = time.perf_counter()
        steps0 = self.steps_done

        self._run_round()
        av, a2, b2 = self._round_obs
        writers.write_display4(self.out, self.model, cfg, a2, b2, av,
                               quiet=self.quiet, t_start=self.t_start)

        if not self.quiet:
            wall = time.perf_counter() - wall_t0
            steps = self.steps_done - steps0
            if steps and wall > 0:
                sites = 2 * (self.model.N + 1) * (self.model.M + 1) * steps
                print(f"\n# perf: {steps} steps in {wall:.3f}s = "
                      f"{steps / wall:.1f} steps/s "
                      f"({sites / wall:.3e} site-updates/s) "
                      f"[impl={self.impl}]")
        if cfg.checkpoint:
            save_state(cfg.checkpoint, self.state, model=self.model,
                       t0=self.t_exit, frame_time=self.frame_time,
                       frame_number=1, last_rem=self.last_rem)
        if self.out not in (sys.stdout, sys.stderr):
            self.out.close()
        return self.state

    def _schedule_kwargs(self):
        cfg = self.cfg
        model = self.model
        return dict(
            omega=model.omega, dt=model.dt, t0=self.t0,
            t_max=self.t_max, t_start=self.t_start,
            E_omega=model.E_omega, display=cfg.display,
            frame_start=cfg.frame_start, T=model.T,
            dtype=model.np_dtype,
            chunk_max=(cfg.steps_per_chunk
                       or (CUDA_CHUNK_DEFAULT if self.impl == "cuda"
                           else TORCH_CHUNK_DEFAULT)),
            frame_time0=self.frame_time,
            last_tT_reminder0=self.last_rem)

    def _run_round(self):
        carry: dict = {}
        for chunk in schedule.iter_chunks(
                carry_out=carry, **self._schedule_kwargs()):
            if self.impl == "cuda":
                self.state = self._cuda_runner().run_xs(
                    self.state, chunk.xs, self.steps_done % 2)
            else:
                self.state, _ = stencil.run_chunk(
                    self.c, self.state, chunk.xs, collect_obs=False)
            self.steps_done += chunk.n_steps
            self._progress(chunk)
        self.frame_time = carry.get("frame_time", self.frame_time)
        self.last_rem = carry.get("last_rem", self.last_rem)
        self.t_exit = carry.get("t_exit", self.t0)
        self._round_obs = self._fetch_round_obs()
        self._check_finite(*self._round_obs[:2])

    def _fetch_round_obs(self):
        """ONE packed device->host transfer per round end: av plus harmonic
        rows 0/1 of a and b — everything the round-end NaN guard and the
        display-4 observable line read."""
        st = self.state
        MP = self.model.MP
        packed = torch.cat([st.av, st.a[:2].reshape(-1),
                            st.b[:2].reshape(-1)]).cpu().numpy()
        return (packed[:8], packed[8:8 + 2 * MP].reshape(2, MP),
                packed[8 + 2 * MP:].reshape(2, MP))

    def _progress(self, chunk):
        # reference: `\rt=... %` every 300 steps
        # (src/boltzmann_c_solver.c:206-213), backfilled after each chunk
        # from the schedule's per-step t values: one line per 300-step
        # boundary crossed, each printing the loop t of the step that
        # completed the period (docs/DEVIATIONS.md D13).
        if self.quiet or self.out is sys.stdout:
            return
        prev = self._steps_since_progress
        total = prev + chunk.n_steps
        self._steps_since_progress = total % 300
        if total < 300:
            return
        ts = chunk.xs["t"]
        # C computes t/t_max*100 in ffloat, so evaluate the percentage at
        # the build dtype or %0.2f can round differently
        D = self.model.np_dtype
        tm = D(self.t_max)
        lines = []
        for k in range(299 - prev, chunk.n_steps, 300):
            t = ts[k]
            pct = float(D(D(t / tm) * D(100))) if tm else 0.0
            lines.append(f"\rt={float(t):0.9f} {pct:0.2f}%")
        sys.stdout.write("".join(lines))
        sys.stdout.flush()

    def _check_finite(self, av, a_rows):
        a0row = a_rows[0, :8]
        if not (np.all(np.isfinite(av)) and np.all(np.isfinite(a0row))):
            raise NumericalInstability(
                "non-finite values in solver state — decrease dt "
                "(reference guidance, src/boltzmann_c_solver.c:56-57)")
