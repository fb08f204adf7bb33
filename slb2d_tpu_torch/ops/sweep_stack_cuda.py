"""The stacked sweep kernel's runner (csrc/sweep_stack.cu): a whole batch
of sweep points advances one chunk per launch.

The port of the JAX package's SweepStackRunner
(slb2d_tpu/ops/sweep_stack.py) in both of its modes.  The state keeps the
canonical batched layout, (B, NHP, MP) arrays (checkpoint and capture
compatible); per-point physics (E_dc, E_omega, B, bdt, the E_omega > 0
averaging gate, and omega, the window end t_end and cos/sin(omega dt) of
the per-omega mode) rides a (B, PP_COLS) column table, and a0/a0_ghost
are (B, NHP, MP) when mu or alpha is swept.  Every chunk has an exact host
table (``stepper_cuda.build_xs_table(exact=True)``, the C driver's
sequential float accumulation, as the batched engine's carried t
accumulates) with lane 6 replaced by the time window to the longest
point's end.

  * shared omega (``sweep_chunk``): the trig of every step is the table's;
  * omega swept (``sweep_chunk_omega``, ``per_omega``): each point's trig
    comes from angle-addition chains re-evaluated exactly every
    TRIG_RESYNC steps of a chunk, its averaging window ends at its own
    t_end, and its loop-exit capture (the display-4 sums at its last step
    with t < t_end, and with frames its arrays a, b) is rolled in the
    kernel into arrays that ``advance`` threads through, as the JAX
    runner threads its ``cap``.

Two forms of the kernel compute the same function (csrc/sweep_stack.cu):
the cluster form keeps each point's state in the shared memory of a
thread-block cluster for the whole chunk; the streaming form, one block
per point with its state in device memory, serves points no portable
cluster holds.  ``cluster_plan`` decides which runs.  The state's tensors
are updated in place on the card.

On CPU tensors the runner runs the kernel's plain version
(``run_chunk_plain``, ``run_chunk_plain_omega``); on CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .. import tracing
from . import stencil, stepper_cuda
from .stencil import CAP_KEYS, capture_sums

# per-point column table lanes (csrc/sweep_stack.cu PP_*)
(PP_EDC, PP_EOM, PP_B, PP_BDT, PP_EGATE, PP_OMEGA, PP_TEND, PP_CDT,
 PP_SDT) = range(9)
PP_COLS = 12

# shared-scalar packing order for the kernel's params vector
SCALAR_FIELDS = ("dt", "nu", "nu2", "nu_tilde")

# per-omega chains re-evaluate exactly every TRIG_RESYNC steps of a chunk
# (slb2d_tpu/ops/sweep_stack.py TRIG_RESYNC; csrc/sweep_stack.cu)
TRIG_RESYNC = 32

# one cluster (or block) per point loops over the whole chunk: one launch
LAUNCHES_PER_CHUNK = 1

# The cluster form's shared-memory budget (csrc/sweep_stack.cu, whose
# constants of the same names tests/test_torch_sweep_cluster.py holds to
# these): a block's opt-in shared memory on an H100 (227 KB, the device's
# sharedMemPerBlockOptin), the portable cluster sizes, a rank's slab
# arrays (a, b, a_hs, b_hs) and edge arrays (hs_edge_a, hs_edge_b), and
# the elements of static scratch of the kernel's two block sums (32 warps
# x 3 and x 4).
SMEM_LIMIT = 232448
CLUSTER_SIZES = (1, 2, 4, 8)
SLAB_ARRAYS = 4
EDGE_ARRAYS = 2
SUM_SCRATCH = 224
# the kernel's return code when no cluster of a launch fits on the card
NO_ACTIVE_CLUSTER = -1

# Steps per launch.  The JAX kernel chunks at 512 steps because its xs
# table lives in TPU SMEM; here the table is device memory every block
# reads, so a chunk costs only its host table and one synchronising copy
# (0.11-0.17 ms per chunk for the step kernel, PERF.md §5).
# 16384 steps, as runtime/loop.py's CUDA_CHUNK_DEFAULT, make one period
# of the 64-point sweep (6,283 steps) one launch.  A multiple of
# TRIG_RESYNC, as the JAX runner's 512: a run split into chunks
# re-evaluates its chains at the same steps as one advance() call.
CHUNK_STEPS = 16384

def cluster_smem_bytes(NHP: int, MP: int, dtype, cluster_size: int):
    """The dynamic shared memory of one rank of a cluster of cluster_size
    blocks holding an (NHP, MP) point of dtype, or None where that cluster
    cannot hold it: not a portable size, NHP not split into slabs of at
    least 2 rows (rank 0 holds rows 0 and 1, which the av and capture sums
    read), or the slab and the sums' scratch past SMEM_LIMIT."""
    if cluster_size not in CLUSTER_SIZES or NHP % cluster_size:
        return None
    rows = NHP // cluster_size
    if rows < 2:
        return None
    itemsize = np.dtype(dtype).itemsize
    smem = (SLAB_ARRAYS * rows * MP + EDGE_ARRAYS * rows) * itemsize
    if smem + SUM_SCRATCH * itemsize > SMEM_LIMIT:
        return None
    return smem


def cluster_plan(NHP: int, MP: int, dtype):
    """(cluster size, shared-memory bytes a block) of the cluster form for
    an (NHP, MP) point of dtype: the smallest portable cluster whose ranks
    hold the point's state in shared memory, or None where none does (the
    streaming form runs those; e.g. N=100 M=4000, 6.8 MB a point in
    float).  At N=40 M=500 (NHP=48, MP=512): 2 blocks of 196,800 bytes in
    float, 4 in double."""
    for cs in CLUSTER_SIZES:
        smem = cluster_smem_bytes(NHP, MP, dtype, cs)
        if smem is not None:
            return cs, smem
    return None


def form_info(dtype, per_omega: bool, cluster_size: int, NHP: int,
              MP: int) -> dict:
    """What a form of the kernel takes on the current card: registers and
    local (spill) bytes a thread, dynamic shared memory a block, and the
    clusters (the streaming form, cluster_size 0: blocks) that run at once
    on the whole card.  Builds the kernels first; needs a card."""
    import ctypes
    from . import _build
    out = (ctypes.c_int * 4)()
    rc = _build.load().cdll.slb_sweep_form_info(
        int(np.dtype(dtype) == np.float64), int(per_omega), cluster_size,
        NHP, MP, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"sweep kernel form query (cluster_size="
                           f"{cluster_size}, NHP={NHP}, MP={MP}) failed: "
                           f"cudaError_t {rc}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                active_clusters=out[3])


def _check_parity(state, parity0):
    if int(state.step[0]) % 2 != parity0:
        raise ValueError(f"parity0={parity0} disagrees with the state's "
                         f"step count {int(state.step[0])}")


def run_chunk_plain(c: stencil.StencilConsts, state: stencil.State, xs,
                    parity0: int, egate):
    """The shared-omega kernel's plain PyTorch version: the batched
    stencil.full_step over the rows of an (n, XS_LANES) table, in the
    reciprocal form the kernel computes, with each point's av gated by xs
    lane 6 and by its egate ((B,) bool, E_omega > 0).  c is the sweep's
    batched consts; parity0 must be the state's step count % 2."""
    _check_parity(state, parity0)
    for i in range(xs.shape[0]):
        row = xs[i]
        trig = tuple(float(v) for v in row[:6])
        do_av = egate & bool(row[6] > 0)
        state = stencil.full_step(c, state, trig, do_av,
                                  use_reciprocal=True)
    return state


def run_chunk_plain_omega(c: stencil.StencilConsts, state: stencil.State,
                          cap, xs, parity0: int, egate, pp, w_d4, w_d4_phi):
    """The per-omega kernel's plain PyTorch version; returns (state, cap).

    The same chains, resync steps, windows and capture as sweep_chunk_omega
    on (B,) tensors: at every step i with i % TRIG_RESYNC == 0 the chains
    are cos/sin of omega·t and omega·(t + dt/2) in the state's dtype (t =
    xs[i, 7]); between resyncs they advance by angle addition with the
    pp columns PP_CDT, PP_SDT.  Both half-steps' mu come from the step's
    chain values through the batched stencil.full_step (reciprocal form).
    A point averages while xs lane 6 is set, its egate holds and t <
    PP_TEND; at its last step with t < PP_TEND (t + dt >= PP_TEND in the
    state's dtype) its entries of cap (a dict of (B,) tensors over
    CAP_KEYS, and with frames of (B, NHP, MP) "a", "b") take
    capture_sums of the new arrays, norm weighted by c.w_av (= w_norm),
    and the new arrays themselves."""
    _check_parity(state, parity0)
    dev = state.a.device
    om, t_end, cdt, sdt = (pp[:, k] for k in (PP_OMEGA, PP_TEND, PP_CDT,
                                              PP_SDT))
    ts = torch.as_tensor(np.ascontiguousarray(xs[:, 7]), device=dev)
    half_dt = c.dt / 2

    def col(v):
        return v.reshape(-1, 1, 1)

    for i in range(xs.shape[0]):
        t = ts[i]
        if i % TRIG_RESYNC == 0:
            t_hs = t + half_dt
            ct, st = torch.cos(om * t), torch.sin(om * t)
            chs, shs = torch.cos(om * t_hs), torch.sin(om * t_hs)
        cos_t_dt = ct * cdt - st * sdt
        sin_t_dt = st * cdt + ct * sdt
        cos_hs_dt = chs * cdt - shs * sdt
        sin_hs_dt = shs * cdt + chs * sdt
        live = t < t_end
        do_av = egate & live & bool(xs[i, 6] > 0)
        state = stencil.full_step(
            c, state, (col(ct), col(cos_t_dt), col(chs), col(cos_hs_dt),
                       ct, st), do_av, use_reciprocal=True)
        exits = live & (t + c.dt >= t_end)
        inst = dict(zip(CAP_KEYS, capture_sums(state, w_d4, w_d4_phi,
                                               c.w_av).unbind(-1)))
        inst.update(a=state.a, b=state.b)
        cap = {k: torch.where(exits.reshape((-1,) + (1,) * (v.dim() - 1)),
                              inst[k], v) for k, v in cap.items()}
        ct, st, chs, shs = cos_t_dt, sin_t_dt, cos_hs_dt, sin_hs_dt
    return state, cap


class SweepStackRunner:
    """advance(states, n_steps[, cap]) for a ParameterSweep batch.  Tracks
    step parity and loop t on the host, so no device scalar is read per
    chunk.  per_omega (omega swept) selects sweep_chunk_omega.

    The form follows cluster_plan: form "cluster" with cluster_size blocks
    a point and smem_bytes of shared memory a block, or form "streaming"
    (cluster_size 0) where no cluster holds a point.  cluster_size forces
    a size (0: the streaming form); one no cluster can take raises."""

    def __init__(self, sweep, cluster_size=None):
        base = sweep.base
        D = base.np_dtype
        self.sweep, self.base = sweep, base
        self.per_omega = "omega" in sweep.params
        self.B, self.NHP, self.MP = sweep.B, base.NHP, base.MP
        if cluster_size is None:
            plan = cluster_plan(self.NHP, self.MP, D)
        elif cluster_size == 0:
            plan = None
        else:
            smem = cluster_smem_bytes(self.NHP, self.MP, D, cluster_size)
            if smem is None:
                raise ValueError(
                    f"sweep runner: a cluster of {cluster_size} blocks "
                    f"cannot hold an (NHP={self.NHP}, MP={self.MP}) "
                    f"{np.dtype(D).name} point (sizes {CLUSTER_SIZES}, "
                    f">= 2 rows a block, {SMEM_LIMIT} bytes)")
            plan = cluster_size, smem
        self.form = "streaming" if plan is None else "cluster"
        self.cluster_size, self.smem_bytes = plan or (0, 0)
        self.tdtype = torch.float32 if D == np.float32 else torch.float64
        dev = sweep.device
        pp = np.zeros((self.B, PP_COLS), D)
        for p, m in enumerate(sweep.models):
            pp[p, PP_EDC] = m.E_dc
            pp[p, PP_EOM] = m.E_omega
            pp[p, PP_B] = m.B
            pp[p, PP_BDT] = m.bdt
            pp[p, PP_EGATE] = 1 if float(m.E_omega) > 0 else 0
            pp[p, PP_OMEGA] = m.omega
            pp[p, PP_TEND] = D(D(base.cfg.t_start) + m.T)
            # angle-addition increments of the per-omega chains, host f64
            # rounded to the state's dtype (sweep_stack.py:504-507)
            pp[p, PP_CDT] = D(np.cos(np.float64(m.omega)
                                     * np.float64(base.dt)))
            pp[p, PP_SDT] = D(np.sin(np.float64(m.omega)
                                     * np.float64(base.dt)))
        self.pp = torch.as_tensor(pp, device=dev)
        self.egate = self.pp[:, PP_EGATE] > 0
        self.w_d4 = torch.as_tensor(base.w_d4, device=dev)
        self.w_d4_phi = torch.as_tensor(base.w_d4_phi, device=dev)
        self.params = np.array([getattr(base, k) for k in SCALAR_FIELDS], D)
        # the xs gate spans to the longest point's window end; in per-omega
        # mode each point's own end rides its PP_TEND column
        self.t_end = float(pp[:, PP_TEND].max())
        self.host = types.SimpleNamespace(omega=base.omega, dt=base.dt)
        self.a0_batched = sweep.consts.a0.dim() == 3
        self.step0 = 0
        self.t0 = 0.0
        self.launches = 0
        self._xs_dev = None      # the last chunk's table, kept alive while
                                 # its launch may still run

    def seek(self, done_steps):
        """Position the host-side (t, step) trackers at an absolute step
        count (checkpoint resume)."""
        if done_steps != self.step0:
            from ..runtime.schedule import accum_sequence
            self.step0 = done_steps
            self.t0 = float(accum_sequence(0.0, float(self.base.dt),
                                           done_steps,
                                           self.base.np_dtype)[-1])

    def chunk_table(self, n):
        """The (n, XS_LANES) table of the next n steps from the trackers:
        exact trig and loop t; lane 6 is the time window to the longest
        point's end, and each point's E_omega gate rides its egate
        column."""
        D = self.base.np_dtype
        xs = stepper_cuda.build_xs_table(self.base, self.host, self.t0,
                                         self.step0, n, av_enabled=False,
                                         exact=True)
        xs[:, 6] = ((xs[:, 7] >= D(self.base.cfg.t_start))
                    & (xs[:, 7] < D(self.t_end))).astype(D)
        return xs

    def advance(self, states, n_steps, cap=None):
        """Advance the whole batch n_steps, CHUNK_STEPS per launch.

        In per-omega mode cap is the loop-exit capture, a dict of (B,)
        tensors over CAP_KEYS (zeros on a fresh start) and, for frames, of
        (B, NHP, MP) "a", "b"; the return value is (states, new cap dict).
        With a shared omega cap is not taken and the return value is
        states."""
        D = self.base.np_dtype
        dev = states.a.device
        if self.per_omega:
            if cap is None:
                raise ValueError("the per-omega sweep kernel threads the "
                                 "loop-exit capture: pass cap")
            cap = {k: v.to(device=dev, dtype=self.tdtype)
                   for k, v in cap.items()}
        elif cap is not None:
            raise ValueError("a shared-omega sweep takes no cap")
        done = 0
        while done < n_steps:
            k = min(CHUNK_STEPS, n_steps - done)
            xs = self.chunk_table(k)
            parity0 = self.step0 % 2
            if dev.type == "cpu":
                if self.per_omega:
                    states, cap = run_chunk_plain_omega(
                        self.sweep.consts, states, cap, xs, parity0,
                        self.egate, self.pp, self.w_d4, self.w_d4_phi)
                else:
                    states = run_chunk_plain(self.sweep.consts, states, xs,
                                             parity0, self.egate)
            elif dev.type == "cuda":
                states, cap = self._launch(states, xs, cap)
            else:
                raise ValueError(f"sweep runner: unsupported device {dev}")
            # t continues exactly: the last row's loop t plus one dt
            t_next = D(xs[k - 1, 7] + D(self.base.dt))
            states = states.replace(t=torch.full(
                (self.B,), float(t_next), dtype=self.tdtype, device=dev))
            self.step0 += k
            self.t0 = float(t_next)
            done += k
        if self.per_omega:
            return states, cap
        return states

    def _launch(self, states, xs, cap):
        """One launch over the rows of xs; returns (states, cap).  cap is
        None with a shared omega; in per-omega mode its (B,) sums ride one
        (B, 4) array through the launch."""
        from . import _build
        c = self.sweep.consts
        B, NHP, MP = self.B, self.NHP, self.MP
        a0_shape = (B, NHP, MP) if self.a0_batched else (NHP, MP)
        cap_t, frames = None, {}
        if self.per_omega:
            cap_t = torch.stack([cap[k] for k in CAP_KEYS], dim=1)
            frames = cap
        if ("a" in frames) != ("b" in frames):
            raise ValueError("sweep runner: frames capture both a and b")
        tensors = dict(
            a=states.a, b=states.b, a_hs=states.a_hs, b_hs=states.b_hs,
            hs_edge_a=states.hs_edge_a, hs_edge_b=states.hs_edge_b,
            av=states.av, cap=cap_t, cap_a=frames.get("a"),
            cap_b=frames.get("b"), a0=c.a0, a0_ghost=c.a0_ghost, phi=c.phi,
            w_av=c.w_av, w_av_phi=c.w_av_phi, w_d4=self.w_d4,
            w_d4_phi=self.w_d4_phi, pp=self.pp)
        shapes = dict(a=(B, NHP, MP), b=(B, NHP, MP), a_hs=(B, NHP, MP),
                      b_hs=(B, NHP, MP), hs_edge_a=(B, NHP),
                      hs_edge_b=(B, NHP), av=(B, 8), cap=(B, len(CAP_KEYS)),
                      cap_a=(B, NHP, MP), cap_b=(B, NHP, MP),
                      a0=a0_shape, a0_ghost=a0_shape, phi=(MP,), w_av=(MP,),
                      w_av_phi=(MP,), w_d4=(MP,), w_d4_phi=(MP,),
                      pp=(B, PP_COLS))
        if not self.per_omega:        # the shared-omega entry's arguments
            for name in ("cap", "cap_a", "cap_b", "w_d4", "w_d4_phi"):
                del tensors[name]
        dev = states.a.device
        for name, t in tensors.items():
            if t is None:             # cap_a, cap_b without frames
                continue
            if (t.device != dev or t.dtype != self.tdtype
                    or tuple(t.shape) != shapes[name]
                    or not t.is_contiguous()):
                raise ValueError(
                    f"sweep runner: {name} must be a contiguous "
                    f"{self.tdtype} {shapes[name]} tensor on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        n = xs.shape[0]
        lib = _build.load()
        entry = "slb_sweep_chunk_omega" if self.per_omega else \
            "slb_sweep_chunk"
        suffix = "_f32" if self.tdtype == torch.float32 else "_f64"
        fn = getattr(lib.cdll, entry + suffix)
        with torch.cuda.device(dev):
            xs_dev = torch.from_numpy(
                np.ascontiguousarray(xs, self.base.np_dtype)).to(dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(0 if t is None else t.data_ptr()
                      for t in tensors.values()),
                    self.params.ctypes.data, xs_dev.data_ptr(), B,
                    int(self.a0_batched), self.base.N, self.base.M, NHP, MP,
                    n, self.step0 % 2, self.cluster_size, stream)
        if rc == NO_ACTIVE_CLUSTER:
            raise RuntimeError(
                f"cuda sweep kernel: no cluster of {self.cluster_size} "
                f"blocks with {self.smem_bytes} bytes of shared memory "
                f"fits on {torch.cuda.get_device_name(dev)}")
        if rc != 0:
            raise RuntimeError(f"cuda sweep kernel launch ({self.form} "
                               f"form, cluster_size {self.cluster_size}) "
                               f"failed: cudaError_t {rc}")
        # the process's counters: launches.B3.<shared|omega>.<form>
        self.launches += LAUNCHES_PER_CHUNK
        mode = "omega" if self.per_omega else "shared"
        tracing.count(f"launches.B3.{mode}.{self.form}", LAUNCHES_PER_CHUNK)
        self._xs_dev = xs_dev
        states = states.replace(step=states.step + n)
        if self.per_omega:
            cap = {**cap, **dict(zip(CAP_KEYS, cap_t.unbind(1)))}
        return states, cap
