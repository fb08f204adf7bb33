"""Chunked full-step runner on the hand-written CUDA kernel (csrc/stepper.cu).

The port of the JAX package's Pallas megakernel runner
(slb2d_tpu/ops/stepper_pallas.py:make_pallas_runner).  A chunk's per-step
table (trig, averaging gate, loop t; ``pack_xs_dict`` is the lane
contract) is copied to the card once, and one C call enqueues the whole
chunk: three launches per step plus one per display-77 record, no host
work per step.

The state's tensors are updated in place (the JAX runner donates them):
the State returned holds the same a, b, a_hs, b_hs, edges and av tensors.

On CPU tensors the Runner runs the plain version, ``run_chunk_plain``
(stencil.full_step over the rows of the same packed table).  On CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import stencil

# xs table lanes (per step): cos_t, cos_t_dt, cos_hs, cos_hs_dt,
# cos_av, sin_av, do_av, t, emit77, emit_slot
XS_LANES = 10

# emission-record table width: 4 pre-step sums + t + av[0..7], padded
OBS_LANES = 16

# physics-scalar packing order for the kernel's params vector
SCALAR_FIELDS = ("E_dc", "E_omega", "omega", "B", "dt", "nu", "nu2",
                 "nu_tilde", "bdt", "t_start", "t_end")

# kernel launches per full step: half_step<MAIN>, half_step<HALF>, av_step
LAUNCHES_PER_STEP = 3

# kernel launches made by every Runner of this process (each Runner also
# counts its own in Runner.launches): a driver builds its Runner inside,
# so a caller that wants to show the main path ran on the kernel resets
# this before the run and reads it after
launch_count = 0


def pack_xs_dict(xs_dict, dtype):
    """(n, XS_LANES) xs table from runtime/schedule.iter_chunks columns.
    Fills lanes 0-7 (trig, do_av, t); the emission lanes 8-9 stay zero.
    The lane order is a cross-engine contract (megakernel, stream,
    sweep-stack all consume it) — change it here and nowhere else."""
    n = len(xs_dict["t"])
    xs = np.zeros((n, XS_LANES), dtype)
    xs[:, 0] = xs_dict["cos_t"]
    xs[:, 1] = xs_dict["cos_t_dt"]
    xs[:, 2] = xs_dict["cos_hs"]
    xs[:, 3] = xs_dict["cos_hs_dt"]
    xs[:, 4] = xs_dict["cos_av"]
    xs[:, 5] = xs_dict["sin_av"]
    xs[:, 6] = xs_dict["do_av"].astype(dtype)
    xs[:, 7] = xs_dict["t"]
    return xs


def run_chunk_plain(c: stencil.StencilConsts, state: stencil.State, xs,
                    parity0: int, emit_idx=()):
    """The kernel's plain PyTorch version: stencil.full_step over the rows
    of a packed (n, XS_LANES) table, in the reciprocal form the kernel
    computes (as the JAX megakernel does).  parity0 must be state.step % 2
    (the step count carries the parity here).  Returns (state, obs): obs is an
    (len(emit_idx), OBS_LANES) tensor of display-77 records (emission_record
    layout in lanes 0-12) or None."""
    if int(state.step) % 2 != parity0:
        raise ValueError(f"parity0={parity0} disagrees with the state's "
                         f"step count {int(state.step)}")
    emit = set(int(i) for i in emit_idx)
    records = []
    for i in range(xs.shape[0]):
        row = xs[i]
        trig = tuple(float(v) for v in row[:6])
        new = stencil.full_step(c, state, trig, bool(row[6] > 0),
                                use_reciprocal=True)
        if i in emit:
            records.append(stencil.emission_record(c, state, new))
        state = new
    obs = None
    if records:
        rec = torch.stack(records)
        obs = torch.zeros((len(records), OBS_LANES), dtype=rec.dtype,
                          device=rec.device)
        obs[:, :rec.shape[1]] = rec
    return state, obs


def make_cuda_runner(c: stencil.StencilConsts, model, av_enabled=True,
                     exact_trig=False):
    """(state, n_steps) -> state on the CUDA kernel (CPU tensors: the plain
    version).  Same surface as the JAX package's pallas Runner: run_xs,
    __call__, take_obs, update_consts; plus `launches`, the number of
    kernel launches made so far."""
    D = model.np_dtype
    NHP, MP = model.NHP, model.MP
    tdtype = torch.float32 if D == np.float32 else torch.float64

    class Runner:
        """Tracks step parity and loop t on the host, so no device scalar
        is read per chunk."""

        def __init__(self):
            self.step0 = 0
            self.t0 = 0.0
            self.launches = 0
            self.last_obs = None     # display-77 records of the last run
            self._xs_dev = None      # the last chunk's table, kept alive
                                     # while its launches may still run
            self.update_consts(c)

        def update_consts(self, c_new):
            self.c = c_new
            # host copies of the physics scalars, read once here and not
            # per chunk (reading a device scalar synchronises)
            self.params = np.zeros(16, D)
            for i, name in enumerate(SCALAR_FIELDS):
                self.params[i] = D(float(getattr(c_new, name)))
            self.host = types.SimpleNamespace(
                **dict(zip(SCALAR_FIELDS, self.params)))

        def _run(self, state, xs, n, parity0, emit_idx=()):
            dev = state.a.device
            if dev.type == "cpu":
                out, self.last_obs = run_chunk_plain(self.c, state, xs[:n],
                                                     parity0, emit_idx)
            elif dev.type == "cuda":
                out = self._launch(state, xs, n, parity0, emit_idx)
            else:
                raise ValueError(f"cuda runner: unsupported device {dev}")
            # t continues exactly: the last row's loop t plus one dt,
            # the C driver's sequential accumulation
            t_next = D(xs[n - 1, 7] + self.host.dt)
            return out.replace(t=torch.tensor(t_next, dtype=tdtype,
                                              device=dev))

        def _launch(self, state, xs, n, parity0, emit_idx):
            from . import _build
            c = self.c
            tensors = dict(
                a=state.a, b=state.b, a_hs=state.a_hs, b_hs=state.b_hs,
                hs_edge_a=state.hs_edge_a, hs_edge_b=state.hs_edge_b,
                av=state.av, a0=c.a0, a0_ghost=c.a0_ghost, phi=c.phi,
                w_av=c.w_av, w_av_phi=c.w_av_phi)
            shapes = dict(a=(NHP, MP), b=(NHP, MP), a_hs=(NHP, MP),
                          b_hs=(NHP, MP), a0=(NHP, MP), a0_ghost=(NHP, MP),
                          hs_edge_a=(NHP,), hs_edge_b=(NHP,), av=(8,),
                          phi=(MP,), w_av=(MP,), w_av_phi=(MP,))
            dev = state.a.device
            for name, t in tensors.items():
                if (t.device != dev or t.dtype != tdtype
                        or tuple(t.shape) != shapes[name]
                        or not t.is_contiguous()):
                    raise ValueError(
                        f"cuda runner: {name} must be a contiguous "
                        f"{tdtype} {shapes[name]} tensor on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not 0 < n <= xs.shape[0]:
                raise ValueError(f"cuda runner: n_steps={n} outside the "
                                 f"{xs.shape[0]}-row table")
            emit = np.ascontiguousarray(emit_idx, np.int32)
            if emit.size and (np.any(np.diff(emit) <= 0) or emit[0] < 0
                              or emit[-1] >= n):
                raise ValueError("cuda runner: emit_idx must ascend "
                                 "within the chunk")
            lib = _build.load()
            fn = (lib.cdll.slb_run_chunk_f32 if D == np.float32
                  else lib.cdll.slb_run_chunk_f64)
            with torch.cuda.device(dev):
                xs_dev = torch.from_numpy(
                    np.ascontiguousarray(xs[:n], D)).to(dev)
                obs = torch.zeros((max(1, emit.size), OBS_LANES),
                                  dtype=tdtype, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(*(t.data_ptr() for t in tensors.values()),
                        self.params.ctypes.data, xs_dev.data_ptr(),
                        obs.data_ptr(),
                        emit.ctypes.data if emit.size else None,
                        int(emit.size), model.N, model.M, NHP, MP, int(n),
                        int(parity0), stream)
            if rc != 0:
                raise RuntimeError(f"cuda step kernel launch failed: "
                                   f"cudaError_t {rc}")
            global launch_count
            k = LAUNCHES_PER_STEP * n + int(emit.size)
            self.launches += k
            launch_count += k
            self._xs_dev = xs_dev
            self.last_obs = obs
            return state.replace(step=state.step + n)

        def __call__(self, state, n_steps):
            xs = build_xs_table(model, self.host, self.t0, self.step0,
                                n_steps, av_enabled=av_enabled,
                                exact=exact_trig)
            t_last = xs[-1, 7]
            out = self._run(state, xs, n_steps, self.step0 % 2)
            self.step0 += n_steps
            self.t0 = float(D(t_last + D(self.host.dt)))
            return out

        def run_xs(self, state, xs_dict, parity0, emit_idx=()):
            """Chunk interface for the Simulation driver: xs_dict columns
            from runtime/schedule.iter_chunks.  emit_idx: in-chunk step
            indices at which a display-77 emission record is written
            (fetch via take_obs)."""
            n = len(xs_dict["t"])
            xs = pack_xs_dict(xs_dict, D)
            return self._run(state, xs, n, parity0, emit_idx)

        def take_obs(self, n_emit):
            """The last run's first n_emit display-77 records, fetched in
            ONE transfer, in ops/stencil.emission_record layout
            [norm_sum, v_dr_sum, v_y_sum, m_x_sum, t, av[0..7]]."""
            return self.last_obs[:n_emit, :13].cpu().numpy()

    return Runner()


def build_xs_table(model, c, t0, step0, n_steps, *, av_enabled, exact):
    """Host-side per-step table: trig, averaging gate, loop t.

    fast mode: vectorized float32 trig of t0 + i*dt (matches device_trig
    semantics); exact mode: the C driver's sequential float32 accumulation
    with double-evaluated cos (runtime/schedule semantics).
    """
    D = model.np_dtype
    f64 = np.float64
    xs = np.zeros((n_steps, XS_LANES), D)
    om = D(c.omega)
    dt = D(c.dt)
    if exact:
        # vectorized image of the C driver's sequential f32 accumulation
        # (the same construction runtime/schedule.iter_chunks uses, which
        # is cross-checked against the scalar loop there): strictly
        # sequential t via np.add.accumulate, f32 products, f64 trig
        from ..runtime.schedule import accum_sequence
        ts = accum_sequence(t0, dt, n_steps, D)
        prod = (om * ts).astype(D)
        cos_all = np.cos(prod.astype(f64)).astype(D)
        t_hs = (ts[:n_steps] + D(dt / 2)).astype(D)
        xs[:, 0] = cos_all[:n_steps]
        xs[:, 1] = cos_all[1:]
        xs[:, 2] = np.cos((om * t_hs).astype(D).astype(f64)).astype(D)
        xs[:, 3] = np.cos((om * (t_hs + dt).astype(D)).astype(D)
                          .astype(f64)).astype(D)
        xs[:, 4] = xs[:, 0]
        xs[:, 5] = np.sin(prod[:n_steps].astype(f64)).astype(D)
        xs[:, 7] = ts[:n_steps]
    else:
        # n_steps+1 sample points so cos_t_dt[i] IS cos_t[i+1] bitwise, as
        # the vectorized schedule guarantees by aliasing one cos array
        # (tables stay identical to the JAX package's)
        tt = (D(t0) + np.arange(n_steps + 1, dtype=D) * dt).astype(D)
        cos_all = np.cos(om * tt).astype(D)
        t_hs = (tt[:n_steps] + dt / 2).astype(D)
        xs[:, 0] = cos_all[:n_steps]
        xs[:, 1] = cos_all[1:]
        xs[:, 2] = np.cos(om * t_hs)
        xs[:, 3] = np.cos(om * (t_hs + dt).astype(D))
        xs[:, 4] = xs[:, 0]
        xs[:, 5] = np.sin(om * tt[:n_steps])
        xs[:, 7] = tt[:n_steps]
    if av_enabled and float(c.E_omega) > 0:
        xs[:, 6] = ((xs[:, 7] >= D(c.t_start)) &
                    (xs[:, 7] < D(c.t_end))).astype(D)
    return xs
