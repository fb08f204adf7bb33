"""The simulation driver: chunked time loop over the host step schedule.

The PyTorch counterpart of ``slb2d_tpu/runtime/loop.py`` for one process
on one explicit device.  The hot loop runs host-precomputed step
schedules (runtime/schedule.py) chunk by chunk; the device is
synchronised only at chunk and round boundaries, never per step.

Ported: displays 4 and 77 (records batched per chunk on every engine),
``checkpoint=``, ``warmup`` and ``exact-time=0``. Engines: ``impl=torch``
the plain tensor path; ``impl=stream`` the stream kernel (B2,
ops/stepper_stream_cuda, in its spill or tiling form); ``impl=cuda`` and
``auto`` B1 (ops/stepper_cuda, in its resident or per-half-step form) or B2
by what an H100 measured (stepper_stream_cuda.engine_choice: B1 resident,
else B2 spill, else B2 tiling, else B1 per-half-step). ``exact-time=0``
evaluates the trig on the device from the carried t on ``impl=torch``;
display 77 and the kernel engines keep the schedule's exact tables, as the
JAX package's XLA and pallas paths do. Not yet ported (they raise
NotImplementedError and are listed in ROADMAP.md queue A item 3, or item 9
for ``shards``): displays 3/7/8/9, the stdin parameter server and
``resume=``.
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


# Schedule chunk for the kernel engines.  Each chunk costs one
# synchronising host copy of its xs table and a drained launch queue:
# 0.08-0.39 ms per extra chunk against 13-15 us per step at BASELINE #4
# f32 (H100 80GB HBM3, 700 W; PERF.md §5).  16384 steps keep that under
# 0.2% and the host table at 16384 x 10 values; a BASELINE #4 run is one
# chunk, and its display-77 records are one fetch.
CUDA_CHUNK_DEFAULT = 16384

# impl=torch runs a Python loop per step; the chunk only bounds the xs
# slices (the JAX package's XLA-scan default)
TORCH_CHUNK_DEFAULT = 4096


class NumericalInstability(RuntimeError):
    pass


def _unported(cfg: SimConfig):
    """The first feature of cfg this package does not run yet, or None."""
    if cfg.display not in (4, 77):
        return f"display={cfg.display} (ROADMAP.md queue A item 3)"
    if cfg.read_from == "stdin":
        return "read-from=stdin (ROADMAP.md queue A item 3)"
    if cfg.resume:
        return "resume= (ROADMAP.md queue A item 3)"
    if cfg.shards > 1:
        return "shards>1 (ROADMAP.md queue A item 9)"
    return None


class Simulation:
    def __init__(self, cfg: SimConfig, out=None, device=None):
        missing = _unported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"slb2d_tpu_torch does not run {missing} yet")
        self.cfg = cfg
        # default cuda:<cfg.device> for every impl; the CPU only when asked
        self.device = cfgmod.torch_device(cfg, device)
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
        self.engine = self._select_engine()
        self.c = stencil.consts_from_model(self.model, self.device)
        self._runner = None

    def _select_engine(self):
        """'torch', 'cuda-b1' or 'stream'.  impl=stream on device=cpu runs
        the stream kernel's plain version, as the JAX package's impl=stream
        runs its kernel in interpret mode on the CPU; impl=cuda and auto run
        on a card or not at all.  The kernel engine's runner picks its form
        by the same plans (stepper_stream_cuda.engine_choice)."""
        impl = self.cfg.impl
        if impl == "torch":
            return "torch"
        if impl == "stream" and self.device.type == "cpu":
            return "stream"
        if self.device.type != "cuda":
            raise ValueError(f"impl={impl} needs a CUDA device, got "
                             f"{self.device}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"impl={impl}: no CUDA device is available")
        from ..ops.stepper_stream_cuda import stream_beats_b1
        m = self.model
        if impl == "stream" or stream_beats_b1(m.NHP, m.MP, m.np_dtype):
            return "stream"
        return "cuda-b1"

    def engine_tag(self):
        """The engine and the form its runner took: 'torch', 'cuda-b1
        resident', 'cuda-b1 per-half-step', 'stream spill' or 'stream
        tiling' (before the first chunk the form is not chosen yet:
        'cuda-b1' or 'stream')."""
        form = getattr(self._runner, "form", None)
        return f"{self.engine} {form}" if form else self.engine

    def _kernel_runner(self):
        if self._runner is None:
            if self.engine == "stream":
                from ..ops.stepper_stream_cuda import make_stream_runner
                self._runner = make_stream_runner(self.c, self.model)
            else:
                from ..ops.stepper_cuda import make_cuda_runner
                self._runner = make_cuda_runner(self.c, self.model)
        return self._runner

    def _compute_t_max(self):
        D = self.model.np_dtype
        return float(D(D(self.t_start) + self.model.T))

    # -- main ----------------------------------------------------------------

    def run(self):
        """One round (display 4: its line at the end; display 77: its
        lines per chunk); returns the final State."""
        cfg = self.cfg
        if not self.quiet:
            print(f"# t_max = {writers.f20(self.model.np_dtype(self.t_max))}")
        wall_t0 = time.perf_counter()
        steps0 = self.steps_done

        self._run_round()
        if cfg.display == 4:
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
                      f"[impl={self.engine_tag()}]")
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
                       or (TORCH_CHUNK_DEFAULT if self.engine == "torch"
                           else CUDA_CHUNK_DEFAULT)),
            frame_time0=self.frame_time,
            last_tT_reminder0=self.last_rem,
            # display 77: the records of a chunk's emission steps are
            # written on the device and fetched once per chunk
            break_on_e77=False)

    def warmup(self):
        """Build and run, once each, what the coming round will run, on a
        throwaway copy of the state (slb2d_tpu/runtime/loop.py:337-380).
        Nothing here is jit-compiled: on a kernel engine this is the nvcc
        build of the kernel library (at first use in the process) and one
        run of the runner over the round's first chunk, on impl=torch one
        run of each distinct chunk length.  Keeps the build and first-use
        costs out of a timed run; it changes no result."""
        seen = set()
        steps = self.steps_done
        for chunk in schedule.iter_chunks(**self._schedule_kwargs()):
            # one runner serves every chunk length on the kernel engines
            key = "kernel" if self.engine != "torch" else chunk.n_steps
            parity = steps % 2
            steps += chunk.n_steps
            if key in seen:
                continue
            seen.add(key)
            self._run_chunk(self.state.clone(), chunk, parity)
        self._fetch_round_obs()

    def _run_chunk(self, state, chunk, parity):
        """(state after the chunk, its display-77 records) on the
        engine."""
        emit = chunk.emit_idx
        if self.engine != "torch":
            runner = self._kernel_runner()
            state = runner.run_xs(state, chunk.xs, parity, emit_idx=emit)
            return state, (runner.take_obs(len(emit)) if emit else ())
        # exact-time=0 on the tensor path: trig from the carried t; display
        # 77 averages only at emission steps, which only the schedule's
        # tables know, so it keeps them (slb2d_tpu/runtime/loop.py:188-195)
        exact = self.cfg.exact_time or self.cfg.display == 77
        state, ys = stencil.run_chunk(
            self.c, state, chunk.xs, collect_obs=bool(emit),
            exact_trig=exact, av_enabled=self.cfg.display not in (7, 77, 8))
        return state, (ys[list(emit)].cpu().numpy() if emit else ())

    def _run_round(self):
        carry: dict = {}
        for chunk in schedule.iter_chunks(
                carry_out=carry, **self._schedule_kwargs()):
            self.state, records = self._run_chunk(
                self.state, chunk, self.steps_done % 2)
            for rec in records:
                writers.write_display77_from_record(
                    self.out, self.model, rec, quiet=self.quiet)
            self.steps_done += chunk.n_steps
            self._progress(chunk)
        self.frame_time = carry.get("frame_time", self.frame_time)
        self.last_rem = carry.get("last_rem", self.last_rem)
        self.t_exit = carry.get("t_exit", self.t0)
        self._round_obs = self._fetch_round_obs()
        self._check_finite(*self._round_obs[:2])

    def _fetch_round_obs(self):
        """ONE packed device->host transfer per round end: av plus (for
        display 4) harmonic rows 0/1 of a and b — everything the round-end
        NaN guard and the display-4 observable line read."""
        st = self.state
        if self.cfg.display != 4:
            packed = torch.cat([st.av, st.a[0, :8]]).cpu().numpy()
            return packed[:8], packed[8:16].reshape(1, 8), None
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
