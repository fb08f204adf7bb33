"""Chunked full-step runner on the hand-written CUDA kernel (csrc/stepper.cu).

The port of the JAX package's Pallas megakernel runner
(slb2d_tpu/ops/stepper_pallas.py:make_pallas_runner).  A chunk's per-step
table (trig, averaging gate, loop t; ``pack_xs_dict`` is the lane
contract) is copied to the card once, and one C call enqueues the whole
chunk, with no host work per step, in one of two forms of the kernel:

  * resident: ONE cooperative launch per chunk, one block per SM, each
    holding a band of W columns of the whole state in shared memory for
    the chunk (display-77 records written in the kernel);
  * per-half-step: three launches per step plus one per display-77
    record, the state in device memory.

``resident_plan`` decides the form before anything launches: the
resident form wherever its bands hold the state (every f32 grid up to
~29 MB of state, BASELINE #4 in f64), the per-half-step form elsewhere (f64
at the tall and wide grids).  A form asked for that cannot hold the shape
raises; nothing falls back at run time.

The state's tensors are updated in place (the JAX runner donates them):
the State returned holds the same a, b, a_hs, b_hs, edges and av tensors.

On CPU tensors the Runner runs the plain version, ``run_chunk_plain``
(stencil.full_step over the rows of the same packed table), whatever its
form.  On CUDA tensors it launches the kernel or raises; nothing falls
back.
"""

from __future__ import annotations

import types
from typing import NamedTuple

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

# the per-half-step form's launches per full step: half_step<MAIN>,
# half_step<HALF>, av_step (and one record_step per display-77 record)
LAUNCHES_PER_STEP = 3
# the resident form's launches per chunk: one cooperative launch
LAUNCHES_PER_CHUNK = 1

FORMS = ("resident", "per-half-step")

# The resident form's budget (csrc/stepper.cu, whose constants of the same
# names tests/test_torch_stepper_resident.py holds to these): a block's
# opt-in shared memory on an H100 (227 KB); the halo columns on each side
# of a band's a, b (computed by the band) and of its a_hs, b_hs
# (exchanged); the xs rows staged at a time (plus the next); the band
# width's unit (a warp's lanes on neighbouring columns) and its largest
# value, the largest block, and the elements of static scratch of the row
# sums (2 rows x 16 warps x 2 values).
SMEM_LIMIT = 232448
HALO_MAIN = 1
HALO_HALF = 2
XS_STAGE = 32
BAND_ALIGN = 32
MAX_BAND = 512
RESIDENT_BLOCK = 1024
RESIDENT_SCRATCH = 64
# the partial sums a band leaves per step (norm, v_dr, v_y, m_x), and the
# values it publishes per row and step (its first two and last two
# columns of a_hs and b_hs)
PART_LANES = 4
XCH_LANES = 8
# the kernel's return code when the card cannot run every band at once
NOT_CO_RESIDENT = -2
# an H100 SXM's SMs: the most bands a plan takes where no card is asked
SM_COUNT = 132

# kernel launches made by every Runner of this process (each Runner also
# counts its own in Runner.launches), in all and per form: a driver builds
# its Runner inside, so a caller that wants to show the main path ran on
# the kernel resets these before the run and reads them after
launch_count = 0
resident_launch_count = 0
per_half_step_launch_count = 0


class ResidentPlan(NamedTuple):
    W: int            # columns of a band (the last band may have fewer)
    bands: int        # ceil(MP / W): blocks of the launch, one per SM
    smem_bytes: int   # dynamic shared memory a block
    threads: int      # threads a block


def resident_smem_bytes(NHP: int, W: int, dtype) -> int:
    """The dynamic shared memory of a band of W columns: NHP rows of a, b
    with HALO_MAIN columns on each side, of a_hs, b_hs with HALO_HALF, and
    XS_STAGE + 1 rows of the xs table."""
    return (2 * NHP * (W + 2 * HALO_MAIN) + 2 * NHP * (W + 2 * HALO_HALF)
            + (XS_STAGE + 1) * XS_LANES) * np.dtype(dtype).itemsize


def resident_threads(W: int) -> int:
    """Threads of a block with bands of W columns: W / 32 warps across the
    band times 32 / (W / 32) row groups."""
    cw = W // BAND_ALIGN
    return BAND_ALIGN * cw * (RESIDENT_BLOCK // BAND_ALIGN // cw)


def resident_plan(NHP: int, MP: int, dtype, sms: int = SM_COUNT):
    """The resident form's ResidentPlan for an (NHP, MP) state of dtype on
    a card of `sms` SMs, or None where it cannot hold the state: the
    narrowest band, a multiple of BAND_ALIGN up to MAX_BAND, that needs at
    most `sms` bands, whose arrays, halo and the row sums' scratch fit
    SMEM_LIMIT.  A wider band needs more shared memory, so where the
    narrowest does not fit none does.  The tall grid N=400 M=4000
    (NHP=408, MP=4096) in f32: 128 bands of 32 columns, 229,800 bytes; the
    wide grid N=100 M=12000 (MP=12,032): 126 bands of 96 (the last 32);
    f64 at both: None."""
    item = np.dtype(dtype).itemsize
    for W in range(BAND_ALIGN, MAX_BAND + 1, BAND_ALIGN):
        bands = -(-MP // W)
        if bands > sms:
            continue
        smem = resident_smem_bytes(NHP, W, dtype)
        if NHP < 2 or smem + RESIDENT_SCRATCH * item > SMEM_LIMIT:
            return None
        return ResidentPlan(W, bands, smem, resident_threads(W))
    return None


def card_sms(device) -> int:
    """The SMs of a CUDA device, else SM_COUNT."""
    device = torch.device(device)
    if device.type != "cuda":
        return SM_COUNT
    return torch.cuda.get_device_properties(device).multi_processor_count


def form_info(dtype, W: int, NHP: int, MP: int) -> dict:
    """What the resident form takes on the current card with bands of W
    columns: registers and local (spill) bytes a thread, dynamic and
    static shared memory and threads a block, and the blocks that run at
    once on the whole card.  Builds the kernels first; needs a card."""
    import ctypes
    from . import _build
    out = (ctypes.c_int * 6)()
    rc = _build.load().cdll.slb_resident_info(
        int(np.dtype(dtype) == np.float64), W, NHP, MP,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"step kernel resident form query (W={W}, "
                           f"NHP={NHP}, MP={MP}) failed: cudaError_t {rc}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_at_once=out[3], threads=out[4],
                static_smem_bytes=out[5])


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


class Runner:
    """(state, n_steps) -> state on the CUDA kernel (CPU tensors: the plain
    version).  Same surface as the JAX package's pallas Runner: run_xs,
    __call__, take_obs, update_consts; plus `launches`, the number of
    kernel launches made so far.  Tracks step parity and loop t on the
    host, so no device scalar is read per chunk.  Subclasses replace
    _pick_form, _plain, _enqueue and _add_launches
    (ops/stepper_stream_cuda.py).

    `form` is "resident" or "per-half-step": resident_plan's choice for the
    model's shape on the consts' device (a card's SM count), or the form
    asked for; a resident form that cannot hold the shape raises.  `plan`
    is the resident form's ResidentPlan (None on the other form)."""

    engine = "cuda-b1"

    def __init__(self, c: stencil.StencilConsts, model, av_enabled=True,
                 exact_trig=False, form=None):
        self.model = model
        self.av_enabled = av_enabled
        self.exact_trig = exact_trig
        self.dtype = (torch.float32 if model.np_dtype == np.float32
                      else torch.float64)
        self.step0 = 0
        self.t0 = 0.0
        self.launches = 0
        self.last_obs = None     # display-77 records of the last run
        self._xs_dev = None      # the last chunk's table, kept alive
                                 # while its launches may still run
        self._scratch = None     # the resident form's exchange and sums
        self.form, self.plan = self._pick_form(form, c.a0.device)
        self.update_consts(c)

    def _pick_form(self, form, device):
        m = self.model
        plan = resident_plan(m.NHP, m.MP, m.np_dtype, card_sms(device))
        if form is None:
            form = "per-half-step" if plan is None else "resident"
        if form not in FORMS:
            raise ValueError(f"{self.engine} runner: form {form!r} is not "
                             f"one of {FORMS}")
        if form == "resident" and plan is None:
            raise ValueError(
                f"{self.engine} runner: the resident form cannot hold an "
                f"(NHP={m.NHP}, MP={m.MP}) {np.dtype(m.np_dtype).name} "
                f"state ({SMEM_LIMIT} bytes a block, at most "
                f"{card_sms(device)} bands of up to {MAX_BAND} columns)")
        return form, (plan if form == "resident" else None)

    def update_consts(self, c_new):
        D = self.model.np_dtype
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
            out, self.last_obs = self._plain(state, xs[:n], parity0,
                                             emit_idx)
        elif dev.type == "cuda":
            out = self._launch(state, xs, n, parity0,
                               self._emit_array(emit_idx, n))
        else:
            raise ValueError(f"{self.engine} runner: unsupported device "
                             f"{dev}")
        # t continues exactly: the last row's loop t plus one dt,
        # the C driver's sequential accumulation
        t_next = self.model.np_dtype(xs[n - 1, 7] + self.host.dt)
        return out.replace(t=torch.tensor(t_next, dtype=self.dtype,
                                          device=dev))

    def _plain(self, state, xs, parity0, emit_idx):
        return run_chunk_plain(self.c, state, xs, parity0, emit_idx)

    def _tensors(self, state):
        """The kernel's state and constant tensors by name, checked for
        device, type, shape and contiguity."""
        NHP, MP = self.model.NHP, self.model.MP
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
            if (t.device != dev or t.dtype != self.dtype
                    or tuple(t.shape) != shapes[name]
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{self.engine} runner: {name} must be a contiguous "
                    f"{self.dtype} {shapes[name]} tensor on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return tensors

    def _emit_array(self, emit_idx, n):
        emit = np.ascontiguousarray(emit_idx, np.int32)
        if emit.size and (np.any(np.diff(emit) <= 0) or emit[0] < 0
                          or emit[-1] >= n):
            raise ValueError(f"{self.engine} runner: emit_idx must ascend "
                             f"within the chunk")
        return emit

    def _launch(self, state, xs, n, parity0, emit):
        """Copy the chunk's table to the card (lanes 8-9: emission flag and
        record slot), enqueue the kernel's launches (_enqueue) and count
        them."""
        from . import _build
        tensors = self._tensors(state)
        if not 0 < n <= xs.shape[0]:
            raise ValueError(f"{self.engine} runner: n_steps={n} outside "
                             f"the {xs.shape[0]}-row table")
        table = np.array(xs[:n], self.model.np_dtype)
        table[:, 8] = 0
        table[emit, 8] = 1
        table[emit, 9] = np.arange(emit.size)
        lib = _build.load()
        dev = state.a.device
        with torch.cuda.device(dev):
            xs_dev = torch.from_numpy(table).to(dev)
            obs = torch.zeros((max(1, emit.size), OBS_LANES),
                              dtype=self.dtype, device=dev)
            rc, k = self._enqueue(lib.cdll, tensors, xs_dev, obs, emit, n,
                                  parity0,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if rc == NOT_CO_RESIDENT:
            raise RuntimeError(
                f"{self.engine} {self.form} form: the {self.plan.bands} "
                f"blocks of {self.plan.smem_bytes} bytes do not all fit on "
                f"{torch.cuda.get_device_name(dev)} at once")
        if rc != 0:
            raise RuntimeError(f"{self.engine} kernel launch ({self.form} "
                               f"form) failed: cudaError_t {rc}")
        self.launches += k
        self._add_launches(k)
        self._xs_dev = xs_dev
        self.last_obs = obs
        return state.replace(step=state.step + n)

    def _enqueue(self, cdll, tensors, xs_dev, obs, emit, n, parity0,
                 stream):
        """One C call enqueuing the chunk: (cudaError_t, launches)."""
        m = self.model
        suffix = "_f32" if m.np_dtype == np.float32 else "_f64"
        if self.form == "resident":
            xch, part = self._resident_scratch(xs_dev.device)
            rc = getattr(cdll, "slb_resident_chunk" + suffix)(
                *(t.data_ptr() for t in tensors.values()),
                self.params.ctypes.data, xs_dev.data_ptr(), obs.data_ptr(),
                xch.data_ptr(), part.data_ptr(), m.N, m.M, m.NHP, m.MP,
                self.plan.W, int(n), int(parity0), stream)
            return rc, LAUNCHES_PER_CHUNK
        rc = getattr(cdll, "slb_run_chunk" + suffix)(
            *(t.data_ptr() for t in tensors.values()),
            self.params.ctypes.data, xs_dev.data_ptr(), obs.data_ptr(),
            emit.ctypes.data if emit.size else None, int(emit.size),
            m.N, m.M, m.NHP, m.MP, int(n), int(parity0), stream)
        return rc, LAUNCHES_PER_STEP * n + int(emit.size)

    def _resident_scratch(self, dev):
        """The exchange buffer (2 step parities x bands x XCH_LANES x NHP)
        and the bands' partial sums (2 x bands x PART_LANES), allocated once
        per device."""
        if self._scratch is None or self._scratch[0].device != dev:
            bands, NHP = self.plan.bands, self.model.NHP
            self._scratch = (
                torch.empty(2 * bands * XCH_LANES * NHP, dtype=self.dtype,
                            device=dev),
                torch.empty(2 * bands * PART_LANES, dtype=self.dtype,
                            device=dev))
        return self._scratch

    def _add_launches(self, k):
        global launch_count, resident_launch_count
        global per_half_step_launch_count
        launch_count += k
        if self.form == "resident":
            resident_launch_count += k
        else:
            per_half_step_launch_count += k

    def __call__(self, state, n_steps):
        D = self.model.np_dtype
        xs = build_xs_table(self.model, self.host, self.t0, self.step0,
                            n_steps, av_enabled=self.av_enabled,
                            exact=self.exact_trig)
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
        xs = pack_xs_dict(xs_dict, self.model.np_dtype)
        return self._run(state, xs, n, parity0, emit_idx)

    def take_obs(self, n_emit):
        """The last run's first n_emit display-77 records, fetched in
        ONE transfer, in ops/stencil.emission_record layout
        [norm_sum, v_dr_sum, v_y_sum, m_x_sum, t, av[0..7]]."""
        return self.last_obs[:n_emit, :13].cpu().numpy()


def make_cuda_runner(c: stencil.StencilConsts, model, av_enabled=True,
                     exact_trig=False, form=None) -> Runner:
    """The B1 Runner (see Runner); form forces "resident" or
    "per-half-step"."""
    return Runner(c, model, av_enabled=av_enabled, exact_trig=exact_trig,
                  form=form)


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
