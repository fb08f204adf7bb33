"""The simulation driver: chunked time loop, emissions and the REPL.

The PyTorch counterpart of ``slb2d_tpu/runtime/loop.py``, on one device
or, with ``shards>1``, on the "space" slots of a mesh (parallel/mesh.py),
across processes under torch.distributed.  The hot loop runs
host-precomputed step schedules (runtime/schedule.py) chunk by chunk;
the device is synchronised only at emission and round boundaries, never
per step.  The
interactive parameter server (read-from=stdin) continues from the live
state exactly like the reference (src/boltzmann_solver.c:270-281): the
distribution is never reset, only the scalar drive parameters and the
averaging window change, and a kernel engine keeps its runner.

Displays 3, 4, 7, 8, 9 and 77, ``read-from=stdin``, ``checkpoint=``,
``resume=``, ``frame-batch=``, ``warmup`` and ``exact-time=0``.  Engines:
``impl=torch`` the plain tensor path; ``impl=stream`` the stream kernel
(B2, ops/stepper_stream_cuda, in its spill or tiling form); ``impl=cuda``
and ``auto`` B1 (ops/stepper_cuda, in its resident or per-half-step form)
or B2 by what an H100 measured (stepper_stream_cuda.engine_choice: B1
resident, else B2 spill, else B2 tiling, else B1 per-half-step).
``exact-time=0`` evaluates the trig on the device from the carried t on
``impl=torch``; display 77 and the kernel engines keep the schedule's exact
tables, as the JAX package's XLA and pallas paths do.  Display-77 records
are batched per chunk on every engine.  Frames (displays 7, 8 and 9) are
reconstructed on the device in the state's dtype on a card
(ops/frames.reconstruct_on_device), stacked frame-batch at a time and
fetched, formatted and written by one IO thread, with at most
IO_PENDING_MAX batches waiting for it; on the CPU on the host in float64.

``shards=S`` (or a mesh passed in) cuts the phi_y grid over S slots
(parallel/spatial.py): each holds its (NHP, MP/S) slice of the state.
``impl=torch`` runs the sharded plain scan; ``impl=stream``, ``cuda`` and
``auto`` the sharded form of B2 (parallel/stream_shard.ShardedStreamRunner).
The JAX package sends ``auto`` to its sharded XLA scan; the port's plain
scan is a Python loop a step, so ``auto`` takes the kernel.  Values are
gathered onto the first slot's device for frames, the round's observables
and checkpoints (across processes every process gathers).  Across
processes every process runs the same schedule in lockstep: process 0
alone writes files and the output stream (the others write to devnull),
reads the parameter server and broadcasts each mutation, and IO runs
inline, so that no thread orders a collective against the main one.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time

import numpy as np
import torch

from .. import config as cfgmod
from .. import tracing
from ..config import SimConfig  # noqa: F401  (public API)
from ..constants import PI
from ..models.superlattice import SuperlatticeModel
from ..ops import frames, observables, stencil
from ..io import native, writers
from . import schedule
from .checkpoint import load_state, save_state


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

# frame batches queued for the IO thread at most: each holds its frames
# on the device until it is written, and formatting a frame takes ~80x
# longer than producing it (PERF.md §5), so an unbounded queue would hold
# a whole movie on the card
IO_PENDING_MAX = 2


class NumericalInstability(RuntimeError):
    pass


class Simulation:
    # one device, one process, until __init__ says otherwise
    layout = None
    _p0, _nprocs = True, 1

    def __init__(self, cfg: SimConfig, out=None, device=None, mesh=None):
        """device: the run's device (default cuda:<cfg.device>; the CPU
        only when asked).  mesh: a mesh whose "space" axis holds cfg.shards
        slots (default, with shards>1: make_mesh over this process's
        devices, parallel/mesh.local_devices; for the tests and the smoke
        run, a mesh may repeat a device)."""
        self.run_id = tracing.run_id()
        with tracing.span("sim.init", run=self.run_id):
            self._setup(cfg, out, device, mesh)

    def _setup(self, cfg, out, device, mesh):
        from ..parallel.mesh import process_count, process_index
        self.cfg = cfg
        self._runner = None
        self.model = SuperlatticeModel(cfg)
        # the run's plan: its process, layout, device, engine and t_max
        with tracing.span("sim.plan"):
            self._p0 = process_index() == 0
            self._nprocs = process_count()
            self.layout = self._space_layout(device, mesh)
            # default cuda:<cfg.device> for every impl; the CPU only when
            # asked
            self.device = (cfgmod.torch_device(cfg, device)
                           if self.layout is None else self.layout.home)
            self.engine = self._select_engine()
            self.t_start = float(cfg.t_start)
            self.t_max = self._compute_t_max()
        self._set_consts(self.model)
        if out is not None:
            self.out = out
        elif self._p0:
            self.out = cfgmod.open_out(cfg)
        else:
            self.out = open(os.devnull, "w")
        self.quiet = cfg.quiet or not self._p0
        if cfg.display == 77 and self.device.type == "cuda" and self._p0:
            # the display-77 lines' native formatter (io/d77fmt.cpp), made
            # where missing by the process that writes them; the others
            # write to devnull, with it where it is built
            native.build_d77()
        self.recon = None
        self.frame_number = 1
        self.strobe_values = None
        self._frame_batch = []
        self._io_pool = None
        self._io_futures = []
        # cross-round float carries (the reference keeps these across the
        # parameter-server loop)
        self.frame_time = 0.0
        self.last_rem = 0.0
        self.t_exit = 0.0
        self._steps_since_progress = 0
        with tracing.span("sim.bootstrap"):
            if cfg.resume:
                # a sharded run loads on the host and scatters (below)
                self.state, extra = load_state(
                    cfg.resume, self.model,
                    device=self.device if self.layout is None else "cpu")
                self.t0 = float(extra.get("t0", float(self.state.t)))
                self.frame_time = float(extra.get("frame_time", 0.0))
                self.frame_number = int(extra.get("frame_number", 1))
                # display-9 strobe carries: without these a resumed strobe
                # run would drop the accumulated periods and reset the t/T
                # wraparound reminder
                # (src/boltzmann_solver.c:260-275,447-484)
                self.last_rem = float(extra.get("last_rem", 0.0))
                if "strobe_values" in extra:
                    sv = np.asarray(extra["strobe_values"])
                    self.strobe_values = (
                        torch.as_tensor(sv, device=self.device)
                        if self._device_frames() else sv)
                self.steps_done = int(self.state.step)
                if self.layout is not None:
                    self.state = self.layout.scatter_state(self.state)
            else:
                self.state = (
                    stencil.bootstrap_state(self.c, self.model)
                    if self.layout is None
                    else self.layout.bootstrap_state(self.c, self.model))
                self.t0 = 0.0
                self.steps_done = 0

    # -- setup ---------------------------------------------------------------

    def _space_layout(self, device, mesh):
        """The SpaceLayout of a sharded run (shards>1 or a mesh), else
        None.  Fewer devices than shards= raise (make_mesh)."""
        from ..parallel.mesh import local_devices, make_mesh
        from ..parallel.spatial import SpaceLayout
        S = self.cfg.shards
        if mesh is None:
            if S == 1:
                return None
            first = cfgmod.torch_device(self.cfg, device)   # no card: raise
            mesh = make_mesh((S,), ("space",),
                             devices=local_devices(device=first))
        elif mesh.shape.get("space") != S:
            raise ValueError(f"shards={S}, but the mesh's \"space\" axis "
                             f"holds {mesh.shape.get('space')} slots")
        return SpaceLayout(mesh, self.model.MP)

    @tracing.traced("sim.consts")
    def _set_consts(self, model, t_start=None):
        """The run's consts: on one device, or on a sharded run each
        slot's slice of the m-indexed fields (built on the host and
        scattered: no slot's device holds the whole grid's) and its copy
        of the rest."""
        if self.layout is None:
            self.c = stencil.consts_from_model(model, self.device, t_start)
        else:
            self.c = self.layout.scatter_consts(
                stencil.consts_from_model(model, "cpu", t_start))

    def _gather(self, x):
        """A state array (a, b, a_hs, b_hs, or rows of them) whole: on a
        sharded run gathered onto the first slot's device (a collective
        across processes)."""
        return x if self.layout is None else self.layout.gather(x)

    def _first(self, x):
        """A replicated field's value (the first slot's on a sharded
        run)."""
        return x if self.layout is None else x.items[0]

    def _rep(self, x):
        """x on every slot of a sharded run."""
        return x if self.layout is None else self.layout.replicate(x)

    def _select_engine(self):
        """'torch', 'cuda-b1' or 'stream'.  impl=stream on device=cpu runs
        the stream kernel's plain version, as the JAX package's impl=stream
        runs its kernel in interpret mode on the CPU; impl=cuda and auto run
        on a card or not at all.  The kernel engine's runner picks its form
        by the same plans (stepper_stream_cuda.engine_choice); a sharded
        run's kernel engine is B2's sharded form, whose geometry is checked
        here."""
        impl = self.cfg.impl
        if impl == "torch":
            return "torch"
        if impl != "stream" or self.device.type != "cpu":
            if self.device.type != "cuda":
                raise ValueError(f"impl={impl} needs a CUDA device, got "
                                 f"{self.device}")
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"impl={impl}: no CUDA device is available")
        from ..ops.stepper_stream_cuda import stream_beats_b1
        m = self.model
        if self.layout is not None:
            from ..parallel.stream_shard import validate_shard_geometry
            validate_shard_geometry(m.NHP, m.MP, self.layout.S)
            return "stream"
        if impl == "stream" or stream_beats_b1(m.NHP, m.MP, m.np_dtype):
            return "stream"
        return "cuda-b1"

    def engine_tag(self):
        """The engine and the form its runner took: 'torch', 'cuda-b1
        resident', 'cuda-b1 per-half-step', 'stream spill' or 'stream
        tiling' (before the first chunk the form is not chosen yet:
        'cuda-b1' or 'stream'); a sharded run adds its shard count:
        'torch shards=2', 'stream sharded shards=2'."""
        form = getattr(self._runner, "form", None)
        tag = f"{self.engine} {form}" if form else self.engine
        if self.layout is not None:
            tag += f" shards={self.layout.S}"
        return tag

    def _kernel_runner(self):
        if self._runner is None:
            with tracing.span("engine.build"):
                self._runner = self._make_runner()
        return self._runner

    def _make_runner(self):
        if self.layout is not None:
            from ..parallel.stream_shard import ShardedStreamRunner
            return ShardedStreamRunner(self.c, self.model, self.layout)
        if self.engine == "stream":
            from ..ops.stepper_stream_cuda import make_stream_runner
            return make_stream_runner(self.c, self.model)
        from ..ops.stepper_cuda import make_cuda_runner
        return make_cuda_runner(self.c, self.model)

    def _compute_t_max(self):
        D = self.model.np_dtype
        T = self.model.T
        if self.cfg.display == 9:
            # src/boltzmann_solver.c:80-82
            return float(D(D(self.t_start) + D(101 * T)))
        return float(D(D(self.t_start) + T))

    def _get_recon(self):
        if self.recon is None or self.recon.model is not self.model:
            self.recon = frames.FrameReconstructor(self.model)
        return self.recon

    def _device_frames(self):
        """Frames are reconstructed on the device on a card, in the state's
        dtype (the JAX package: float32 on a TPU, whose products have no
        float64), on the host in float64 on the CPU."""
        return self.device.type == "cuda"

    # -- main ----------------------------------------------------------------

    def run(self, repl_stream=None):
        """The whole run, the parameter-server rounds included; returns the
        final State."""
        with tracing.span("sim.run", run=self.run_id):
            return self._run(repl_stream)

    def _run(self, repl_stream):
        cfg = self.cfg
        if cfg.read_from == "stdin" and repl_stream is None:
            repl_stream = sys.stdin
        if not self.quiet:
            print(f"# t_max = {writers.f20(self.model.np_dtype(self.t_max))}")
        wall_t0 = time.perf_counter()
        steps0 = self.steps_done

        while True:
            self._run_round()

            if cfg.display == 3:
                a, b = self._host_ab()
                with tracing.span("io.write"):
                    writers.write_display3(self.out, self.model,
                                           self._get_recon(), a, b)
                break
            if cfg.display == 8:
                # single-shot frame.data (GPU driver semantics,
                # src/boltzmann_solver.c:334-346)
                recon, F, norm = self._frame_and_norm()
                if not self.quiet:
                    print("\nWriting frame frame.data")
                if self._p0:
                    with tracing.span("io.write"), \
                            open("frame.data", "w") as fh:
                        writers.write_frame(fh, self.model, recon, None,
                                            None, self.t_exit, F=F,
                                            norm=norm)
                break
            if cfg.display == 4:
                av, a2, b2 = self._round_obs
                with tracing.span("io.write"):
                    writers.write_display4(self.out, self.model, cfg, a2,
                                           b2, av, quiet=self.quiet,
                                           t_start=self.t_start)

            if repl_stream is None:
                break
            mut = self._scan_params(repl_stream)
            if mut is None:
                break
            self._apply_mutation(*mut)

        if not self.quiet:
            wall = time.perf_counter() - wall_t0
            steps = self.steps_done - steps0
            if steps and wall > 0:
                sites = 2 * (self.model.N + 1) * (self.model.M + 1) * steps
                print(f"\n# perf: {steps} steps in {wall:.3f}s = "
                      f"{steps / wall:.1f} steps/s "
                      f"({sites / wall:.3e} site-updates/s) "
                      f"[impl={self.engine_tag()}]")
        self._drain_io()
        if cfg.checkpoint:
            self._checkpoint()
        if self.out not in (sys.stdout, sys.stderr):
            self.out.close()
        return self.state

    @tracing.traced("sim.checkpoint")
    def _checkpoint(self):
        """The whole state, gathered on every process (a collective across
        processes); process 0 alone writes the file, in the format of an
        unsharded run."""
        state = (self.state if self.layout is None
                 else self.layout.gather_state(self.state))
        extra = {}
        if self.strobe_values is not None:
            extra["strobe_values"] = self._fetch_np(self.strobe_values)
        if self._p0:
            save_state(self.cfg.checkpoint, state, model=self.model,
                       t0=self.t_exit, frame_time=self.frame_time,
                       frame_number=self.frame_number,
                       last_rem=self.last_rem, **extra)

    @staticmethod
    def _fetch_np(x):
        """A device tensor (or host array) as a host numpy array."""
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

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
        run of each distinct chunk length; then, for the frame displays,
        one reconstruction.  Keeps the build and first-use costs out of a
        timed run; it changes no result."""
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
        if self.cfg.display in (3, 7, 8, 9):
            F, _, _ = self._frame_parts()
            self._fetch_np(F)
        self._fetch_round_obs()

    def _run_chunk(self, state, chunk, parity):
        """(state after the chunk, its display-77 records) on the
        engine."""
        emit = chunk.emit_idx
        if self.engine != "torch":
            runner = self._kernel_runner()
            with tracing.span("engine.chunk"):
                state = runner.run_xs(state, chunk.xs, parity, emit_idx=emit)
            if not emit:
                return state, ()
            with tracing.span("engine.fetch"):
                return state, runner.take_obs(len(emit))
        # exact-time=0 on the tensor path: trig from the carried t; display
        # 77 averages only at emission steps, which only the schedule's
        # tables know, so it keeps them (slb2d_tpu/runtime/loop.py:188-195)
        exact = self.cfg.exact_time or self.cfg.display == 77
        hooks = ({} if self.layout is None else
                 dict(shift=self.layout.shift, sum_m=self.layout.sum_m))
        with tracing.span("engine.chunk"):
            state, ys = stencil.run_chunk(
                self.c, state, chunk.xs, collect_obs=bool(emit),
                exact_trig=exact,
                av_enabled=self.cfg.display not in (7, 77, 8), **hooks)
        if not emit:
            return state, ()
        with tracing.span("engine.fetch"):
            return state, self._first(ys)[list(emit)].cpu().numpy()

    def _run_round(self):
        carry: dict = {}
        for chunk in tracing.spanned("schedule.chunk", schedule.iter_chunks(
                carry_out=carry, **self._schedule_kwargs())):
            self.state, records = self._run_chunk(
                self.state, chunk, self.steps_done % 2)
            if len(records):
                with tracing.span("io.write"):
                    writers.write_display77_from_record(
                        self.out, self.model, records, quiet=self.quiet)
            self.steps_done += chunk.n_steps
            tracing.count("engine.chunks")
            self._handle_event(chunk)
            self._progress(chunk)
        self._flush_frame_batch()
        self.frame_time = carry.get("frame_time", self.frame_time)
        self.last_rem = carry.get("last_rem", self.last_rem)
        self.t_exit = carry.get("t_exit", self.t0)
        self._round_obs = self._fetch_round_obs()
        self._check_finite(*self._round_obs[:2])

    @tracing.traced("engine.fetch")
    def _fetch_round_obs(self):
        """ONE packed device->host transfer per round end: av plus (for
        display 4) harmonic rows 0/1 of a and b — everything the round-end
        NaN guard and the display-4 observable line read."""
        st = self.state
        av = self._first(st.av)
        if self.cfg.display != 4:
            packed = torch.cat([av, self._gather(st.a[0])[:8]]).cpu().numpy()
            return packed[:8], packed[8:16].reshape(1, 8), None
        MP = self.model.MP
        packed = torch.cat([av, self._gather(st.a[:2]).reshape(-1),
                            self._gather(st.b[:2]).reshape(-1)]
                           ).cpu().numpy()
        return (packed[:8], packed[8:8 + 2 * MP].reshape(2, MP),
                packed[8 + 2 * MP:].reshape(2, MP))

    def _handle_event(self, chunk):
        if chunk.event in ("e7", "e9"):
            with tracing.span("frames.build"):
                self._frame_event(chunk)

    def _frame_event(self, chunk):
        if chunk.event == "e7":
            F, norm_sum, finish = self._frame_parts()
            self._enqueue_frame("frame", F, norm_sum, finish, chunk.t_last)
        else:
            # strobe accumulation stays on the device on a card
            # (on the host otherwise); each period's snapshot rides the
            # same batched transfer as movie frames (reference: per-period
            # D2H, src/boltzmann_solver.c:260-275)
            F, norm_sum, finish = self._frame_parts()
            if self.strobe_values is None:
                self.strobe_values = F
            else:
                self.strobe_values = self.strobe_values + F
            self._enqueue_frame("strobe", self.strobe_values, norm_sum,
                                finish, chunk.t_last)

    def _progress(self, chunk):
        # reference: `\rt=... %` every 300 steps
        # (src/boltzmann_c_solver.c:206-213), backfilled after each chunk
        # from the schedule's per-step t values: one line per 300-step
        # boundary crossed, each printing the loop t of the step that
        # completed the period (docs/DEVIATIONS.md D13).  Display 7 prints
        # its frame lines instead.
        if self.quiet or self.out is sys.stdout or self.cfg.display == 7:
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

    # -- frames --------------------------------------------------------------

    def _io_submit(self, fn):
        """Queue fn on the IO thread, after waiting for the oldest batch
        while IO_PENDING_MAX of them are queued; across processes run it
        inline (the JAX driver's rule: no thread of a process may order
        a collective against its main thread)."""
        if self._nprocs > 1:
            fn()
            return
        if self._io_pool is None:
            self._io_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
            self._io_futures = []
        futures = self._io_futures
        if len(futures) >= IO_PENDING_MAX:
            with tracing.span("io.wait"):
                while len(futures) >= IO_PENDING_MAX:
                    futures.pop(0).result()
        futures.append(self._io_pool.submit(fn))

    def _drain_io(self):
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=True)
            self._io_pool = None
            futures, self._io_futures = self._io_futures, []
            for f in futures:
                f.result()   # surface write errors instead of losing them

    def _enqueue_frame(self, kind, F, norm_sum, finish, t):
        """Queue one frame or strobe emission; they accumulate on the
        device and cross to the host as ONE stacked transfer per
        frame_batch entries (the reference paid a D2H pair per emission,
        src/boltzmann_solver.c:260-287).  Up to frame_batch-1 queued
        emissions are lost if the process dies mid-round; frame-batch=1
        writes each emission as it comes."""
        fname = f"{kind}{self.frame_number:08d}.data"
        self.frame_number += 1
        if not self.quiet:
            print(f"\nWriting {kind} {fname}")
        self._frame_batch.append((fname, F, norm_sum, finish, t, kind))
        if len(self._frame_batch) >= max(1, self.cfg.frame_batch):
            self._flush_frame_batch()

    def _flush_frame_batch(self):
        """Stack the pending frames (on the device on a card) and
        submit one fetch + format + write job; the single IO worker keeps
        the files in order.  Each F is a fresh tensor, never a view of the
        state, so the kernels' in-place updates of the next chunks cannot
        reach it."""
        batch, self._frame_batch = self._frame_batch, []
        if not batch:
            return
        model = self.model
        recon = self._get_recon()
        on_device = batch[0][2] is not None
        Fs = (torch.stack([rec[1] for rec in batch]) if on_device
              else np.stack([np.asarray(rec[1]) for rec in batch]))
        ns = torch.stack([rec[2] for rec in batch]) if on_device else None
        run = self.run_id

        def write(batch=batch, Fs=Fs, ns=ns):
            if not self._p0:
                return                        # process 0's files
            with tracing.span("io.fetch", run=run):
                Fh = self._fetch_np(Fs)       # ONE transfer for k frames
                nh = (self._fetch_np(ns) if ns is not None
                      else [None] * len(batch))
            with tracing.span("io.format", run=run):
                for i, (fname, _, _, finish, t, kind) in enumerate(batch):
                    with open(fname, "w") as fh:
                        if kind == "strobe":
                            writers.write_strobe(fh, model, recon, Fh[i],
                                                 None, t,
                                                 norm=finish(nh[i]))
                        else:
                            writers.write_frame(fh, model, recon, None,
                                                None, t, F=Fh[i],
                                                norm=finish(nh[i]))
        self._io_submit(write)

    def _frame_parts(self):
        """(F, norm_sum, finish): the current frame (m = 1..M+1), on the
        device on a card (F and norm_sum stay device tensors;
        finish(norm_sum_host) applies the final scaling), else on the host
        in float64 (norm_sum None, finish returns the norm)."""
        model = self.model
        recon = self._get_recon()
        if self._device_frames():
            F, norm_sum = recon.reconstruct_on_device(
                self._gather(self.state.a), self._gather(self.state.b), 1,
                model.M + 2)
            D = model.np_dtype
            scale = 2 * PI * np.sqrt(np.float64(model.alpha))

            def finish(s):
                return D(np.float64(D(s)) * scale)
            return F, norm_sum, finish
        a, b = self._host_ab()
        F = recon.reconstruct(a, b, 1, model.M + 2)
        norm = observables.eval_norm(model, a)
        return F, None, (lambda s, _n=norm: _n)

    @tracing.traced("engine.fetch")
    def _host_ab(self):
        return (self._fetch_np(self._gather(self.state.a)),
                self._fetch_np(self._gather(self.state.b)))

    def _frame_and_norm(self):
        """(recon, F, norm) of the current frame, fetched to the host."""
        with tracing.span("frames.build"):
            F, ns, finish = self._frame_parts()
        with tracing.span("engine.fetch"):
            norm = finish(self._fetch_np(ns) if ns is not None else None)
            return self._get_recon(), self._fetch_np(F), norm

    def _check_finite(self, av, a_rows):
        a0row = a_rows[0, :8]
        if not (np.all(np.isfinite(av)) and np.all(np.isfinite(a0row))):
            raise NumericalInstability(
                "non-finite values in solver state — decrease dt "
                "(reference guidance, src/boltzmann_c_solver.c:56-57)")

    # -- parameter server ----------------------------------------------------

    def _scan_params(self, stream):
        """One parameter-server read; across processes process 0 reads the
        stream and broadcasts the mutation, so that every process applies
        the same change in lockstep."""
        if self._nprocs == 1:
            return cfgmod.scan_for_new_parameters(stream)
        from ..parallel.collectives import broadcast_object
        return broadcast_object(cfgmod.scan_for_new_parameters(stream)
                                if self._p0 else None)

    @tracing.traced("sim.mutation")
    def _apply_mutation(self, name, value, timeout):
        """One live parameter change: t_start moves to t+timeout, t_max =
        t_start + OLD T, then T re-derives; averaging restarts; the
        distribution state is preserved (reference :270-281).

        Mutation semantics follow the GPU driver (docs/DEVIATIONS.md D11):
        drive scalars (E_dc, E_omega, omega, B) and the output multipliers
        go live, but the equilibrium a0 and the magnetic stencil constant
        bdt stay frozen at their startup values (src/boltzmann_solver.c
        never recomputes them, :112-126).  A kernel engine keeps its
        runner, its form and its buffers: only its scalars change
        (Runner.update_consts), and each launch reads them."""
        model = self.model
        D = model.np_dtype
        t = D(self.t_exit)             # C's loop-exit t
        old_T = model.T
        if name is not None:
            frozen = (model.a0, model.a0_ghost, model.bdt)
            self.cfg = self.cfg.replace(**{name: value})
            self.model = SuperlatticeModel(self.cfg)
            self.model.a0, self.model.a0_ghost, self.model.bdt = frozen
            model = self.model
        self.t_start = float(D(t + D(timeout)))
        self.t_max = float(D(D(self.t_start) + old_T))
        self.t0 = float(D(t + model.dt))
        # the averaging window moved: the live t_start in the stencil
        # consts (fast-trig mode gates on it) and in the runner's scalars
        self._set_consts(model, t_start=self.t_start)
        if self._runner is not None:
            self._runner.update_consts(self.c)
        self.state = self.state.replace(
            av=self._rep(torch.zeros(8, dtype=self.state.a.dtype,
                                     device=self.device)),
            t=self._rep(torch.tensor(D(self.t0), device=self.device)))
        if not self.quiet:
            print(f"# t_max = {writers.f20(D(self.t_max))}")
