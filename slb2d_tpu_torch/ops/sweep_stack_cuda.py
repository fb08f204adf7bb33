"""The stacked sweep kernel's runner (csrc/sweep_stack.cu): a whole batch
of sweep points advances one chunk per launch.

The port of the JAX package's SweepStackRunner
(slb2d_tpu/ops/sweep_stack.py) in its shared-omega mode.  The state keeps
the canonical batched layout, (B, NHP, MP) arrays (checkpoint and capture
compatible); per-point physics (E_dc, E_omega, B, bdt and the E_omega > 0
averaging gate) rides a (B, PP_COLS) column table, and a0/a0_ghost are
(B, NHP, MP) when mu or alpha is swept.  Trig comes from the chunk's
exact host table (``stepper_cuda.build_xs_table(exact=True)``, the C
driver's sequential float accumulation, as the batched engine's carried t
accumulates) with lane 6 replaced by the shared time window.

The state's tensors are updated in place on the card.

On CPU tensors the runner runs the kernel's plain version,
``run_chunk_plain``; on CUDA tensors it launches the kernel or raises;
nothing falls back.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import stencil, stepper_cuda

# per-point column table lanes (csrc/sweep_stack.cu PP_*)
PP_EDC, PP_EOM, PP_B, PP_BDT, PP_EGATE = range(5)
PP_COLS = 8

# shared-scalar packing order for the kernel's params vector
SCALAR_FIELDS = ("dt", "nu", "nu2", "nu_tilde")

# one thread block per point loops over the whole chunk: one launch
LAUNCHES_PER_CHUNK = 1

# Steps per launch.  The JAX kernel chunks at 512 steps because its xs
# table lives in TPU SMEM; here the table is device memory every block
# reads, so a chunk costs only its host table and one synchronising copy
# (0.11-0.17 ms per chunk for the step kernel, PERF.md "Chunk length").
# 16384 steps, as runtime/loop.py's CUDA_CHUNK_DEFAULT, make one period
# of the 64-point sweep (6,283 steps) one launch.
CHUNK_STEPS = 16384

# kernel launches made by every runner of this process (each runner also
# counts its own in .launches): a caller that wants to show the main path
# ran on the kernel resets this before the run and reads it after
launch_count = 0


def run_chunk_plain(c: stencil.StencilConsts, state: stencil.State, xs,
                    parity0: int, egate):
    """The kernel's plain PyTorch version: the batched stencil.full_step
    over the rows of an (n, XS_LANES) table, in the reciprocal form the
    kernel computes, with each point's av gated by xs lane 6 and by its
    egate ((B,) bool, E_omega > 0).  c is the sweep's batched consts;
    parity0 must be the state's step count % 2."""
    if int(state.step[0]) % 2 != parity0:
        raise ValueError(f"parity0={parity0} disagrees with the state's "
                         f"step count {int(state.step[0])}")
    for i in range(xs.shape[0]):
        row = xs[i]
        trig = tuple(float(v) for v in row[:6])
        do_av = egate & bool(row[6] > 0)
        state = stencil.full_step(c, state, trig, do_av,
                                  use_reciprocal=True)
    return state


class SweepStackRunner:
    """advance(states, n_steps) for a ParameterSweep batch with a shared
    omega.  Tracks step parity and loop t on the host, so no device scalar
    is read per chunk."""

    def __init__(self, sweep):
        if "omega" in sweep.params:
            raise NotImplementedError(
                "the sweep kernel's per-omega mode (B3, ROADMAP.md queue B) "
                "is not ported; omega sweeps run on the batched engine")
        base = sweep.base
        D = base.np_dtype
        self.sweep, self.base = sweep, base
        self.B, self.NHP, self.MP = sweep.B, base.NHP, base.MP
        self.tdtype = torch.float32 if D == np.float32 else torch.float64
        dev = sweep.device
        pp = np.zeros((self.B, PP_COLS), D)
        for p, m in enumerate(sweep.models):
            pp[p, PP_EDC] = m.E_dc
            pp[p, PP_EOM] = m.E_omega
            pp[p, PP_B] = m.B
            pp[p, PP_BDT] = m.bdt
            pp[p, PP_EGATE] = 1 if float(m.E_omega) > 0 else 0
        self.pp = torch.as_tensor(pp, device=dev)
        self.egate = self.pp[:, PP_EGATE] > 0
        self.params = np.array([getattr(base, k) for k in SCALAR_FIELDS], D)
        # the xs gate spans to the longest point's window end (all points
        # share it when omega is shared)
        self.t_end = max(D(D(base.cfg.t_start) + m.T) for m in sweep.models)
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
        exact trig and loop t; lane 6 is the shared time window, and each
        point's E_omega gate rides its egate column."""
        D = self.base.np_dtype
        xs = stepper_cuda.build_xs_table(self.base, self.host, self.t0,
                                         self.step0, n, av_enabled=False,
                                         exact=True)
        xs[:, 6] = ((xs[:, 7] >= D(self.base.cfg.t_start))
                    & (xs[:, 7] < self.t_end)).astype(D)
        return xs

    def advance(self, states, n_steps):
        """Advance the whole batch n_steps, CHUNK_STEPS per launch."""
        D = self.base.np_dtype
        done = 0
        while done < n_steps:
            k = min(CHUNK_STEPS, n_steps - done)
            xs = self.chunk_table(k)
            dev = states.a.device
            if dev.type == "cpu":
                states = run_chunk_plain(self.sweep.consts, states, xs,
                                         self.step0 % 2, self.egate)
            elif dev.type == "cuda":
                states = self._launch(states, xs)
            else:
                raise ValueError(f"sweep runner: unsupported device {dev}")
            # t continues exactly: the last row's loop t plus one dt
            t_next = D(xs[k - 1, 7] + D(self.base.dt))
            states = states.replace(t=torch.full(
                (self.B,), float(t_next), dtype=self.tdtype, device=dev))
            self.step0 += k
            self.t0 = float(t_next)
            done += k
        return states

    def _launch(self, states, xs):
        from . import _build
        c = self.sweep.consts
        B, NHP, MP = self.B, self.NHP, self.MP
        a0_shape = (B, NHP, MP) if self.a0_batched else (NHP, MP)
        tensors = dict(
            a=states.a, b=states.b, a_hs=states.a_hs, b_hs=states.b_hs,
            hs_edge_a=states.hs_edge_a, hs_edge_b=states.hs_edge_b,
            av=states.av, a0=c.a0, a0_ghost=c.a0_ghost, phi=c.phi,
            w_av=c.w_av, w_av_phi=c.w_av_phi, pp=self.pp)
        shapes = dict(a=(B, NHP, MP), b=(B, NHP, MP), a_hs=(B, NHP, MP),
                      b_hs=(B, NHP, MP), hs_edge_a=(B, NHP),
                      hs_edge_b=(B, NHP), av=(B, 8), a0=a0_shape,
                      a0_ghost=a0_shape, phi=(MP,), w_av=(MP,),
                      w_av_phi=(MP,), pp=(B, PP_COLS))
        dev = states.a.device
        for name, t in tensors.items():
            if (t.device != dev or t.dtype != self.tdtype
                    or tuple(t.shape) != shapes[name]
                    or not t.is_contiguous()):
                raise ValueError(
                    f"sweep runner: {name} must be a contiguous "
                    f"{self.tdtype} {shapes[name]} tensor on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        n = xs.shape[0]
        lib = _build.load()
        fn = (lib.cdll.slb_sweep_chunk_f32 if self.tdtype == torch.float32
              else lib.cdll.slb_sweep_chunk_f64)
        with torch.cuda.device(dev):
            xs_dev = torch.from_numpy(
                np.ascontiguousarray(xs, self.base.np_dtype)).to(dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in tensors.values()),
                    self.params.ctypes.data, xs_dev.data_ptr(), B,
                    int(self.a0_batched), self.base.N, self.base.M, NHP, MP,
                    n, self.step0 % 2, stream)
        if rc != 0:
            raise RuntimeError(f"cuda sweep kernel launch failed: "
                               f"cudaError_t {rc}")
        global launch_count
        self.launches += LAUNCHES_PER_CHUNK
        launch_count += LAUNCHES_PER_CHUNK
        self._xs_dev = xs_dev
        return states.replace(step=states.step + n)
