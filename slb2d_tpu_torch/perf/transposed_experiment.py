"""P3 on the card: the step kernel B1's step in the transposed (m, n)
layout (csrc/probe_transposed.cu).

The port of tests/perf/transposed_experiment.py's Pallas probe
``_kernel_T``: the state arrays are (MP, NHL), m on the slow axis and the
harmonic n on the fast one, padded from NHP to NHL columns (NHL=128 at
N=100: 104 live, 23% more elements).  Each step is B1's with av off (the
main half-step, the parity ghost fill, the half-grid half-step against
the new main arrays, the stale column M+1 of the half-step arrays), in
two launches.

Deliberate difference from the JAX probe: that kernel restores a
one-step-old edge column instead of B1's two-step rotation and hard-codes
BASELINE #4's physics scalars ("perf experiment only").  This one
computes B1's real step with the model's scalars, so its state,
transposed back, equals B1's plain version (ops/stepper_cuda.py:
run_chunk_plain, av off) bit for bit, and its time compares like with
like against B1's.

    python -m slb2d_tpu_torch.perf.transposed_experiment [K]

runs K=1000 steps at BASELINE #4 (N=100, M=4000, float32) on the kernel
and on B1 (av off) from one state, checks the two states bit for bit,
prints µs per step of both, each kernel's device µs per launch
(torch.profiler) and one JSON line.  It needs a card (main()
refuses the CPU).  ``run_chunk`` launches the kernel on CUDA tensors and
runs the plain version, ``run_chunk_plain``, on CPU tensors; nothing
falls back.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import types

import numpy as np

from . import have_card, time_ms

NHL = 128
K = 1000
LAUNCHES_PER_STEP = 2
# BASELINE #4 (BASELINE.md #4): the flagship display-4 run's physics and
# grid
PHYS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
            phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3)

# kernel launches made in this process
launch_count = 0


@dataclasses.dataclass
class TState:
    """The state in the transposed layout: a, b, a_hs, b_hs (MP, NHL) with
    columns n >= NHP zero, the carried hs edges (NHP,)."""
    a: object
    b: object
    a_hs: object
    b_hs: object
    hs_edge_a: object
    hs_edge_b: object

    def clone(self) -> "TState":
        return TState(**{f.name: getattr(self, f.name).clone()
                         for f in dataclasses.fields(self)})


@dataclasses.dataclass
class TConsts:
    """What the step reads besides the state: the (NHP, MP) consts `c`
    (for the plain version), a0 and a0_ghost transposed and padded to (MP,
    NHL), phi as an (MP, 1) column, the physics scalars on the host
    (ops/stepper_cuda.py SCALAR_FIELDS order) and the grid."""
    c: object
    a0: object
    a0_ghost: object
    phi: object
    params: np.ndarray
    N: int
    M: int
    NHP: int
    MP: int
    NHL: int


def pad_t(arr, NHL):
    """(NHP, MP) -> (MP, NHL): transposed, columns n >= NHP zero."""
    import torch
    NHP, MP = arr.shape
    out = torch.zeros((MP, NHL), dtype=arr.dtype, device=arr.device)
    out[:, :NHP] = arr.t()
    return out


def unpad_t(arr, NHP):
    """(MP, NHL) -> (NHP, MP): the inverse of pad_t."""
    return arr[:, :NHP].t().contiguous()


def transposed_consts(c, model, NHL=NHL) -> TConsts:
    from ..ops import stepper_cuda
    if NHL < model.NHP:
        raise ValueError(f"NHL={NHL} is below NHP={model.NHP}")
    D = model.np_dtype
    params = np.zeros(16, D)
    for i, name in enumerate(stepper_cuda.SCALAR_FIELDS):
        params[i] = D(float(getattr(c, name)))
    return TConsts(
        c=c, a0=pad_t(c.a0, NHL), a0_ghost=pad_t(c.a0_ghost, NHL),
        phi=c.phi.reshape(-1, 1), params=params, N=model.N, M=model.M,
        NHP=model.NHP, MP=model.MP, NHL=NHL)


def transpose_state(state, NHL=NHL) -> TState:
    """A stencil.State's arrays in the transposed layout."""
    return TState(a=pad_t(state.a, NHL), b=pad_t(state.b, NHL),
                  a_hs=pad_t(state.a_hs, NHL), b_hs=pad_t(state.b_hs, NHL),
                  hs_edge_a=state.hs_edge_a.clone(),
                  hs_edge_b=state.hs_edge_b.clone())


def untranspose(st: TState, NHP) -> dict:
    """The (NHP, MP) arrays and edges of a TState, by stencil.State
    field name."""
    return dict(a=unpad_t(st.a, NHP), b=unpad_t(st.b, NHP),
                a_hs=unpad_t(st.a_hs, NHP), b_hs=unpad_t(st.b_hs, NHP),
                hs_edge_a=st.hs_edge_a, hs_edge_b=st.hs_edge_b)


def run_chunk_plain(tc: TConsts, st: TState, xs, parity0) -> TState:
    """The kernel's plain version: B1's (ops/stepper_cuda.py
    run_chunk_plain) on the state transposed back, over the rows of a
    packed (n, XS_LANES) table, transposed again (the av it may compute
    is dropped: the kernel has none)."""
    import torch
    from ..ops import stencil, stepper_cuda
    dev, dt = st.a.device, st.a.dtype
    state = stencil.State(
        **untranspose(st, tc.NHP), av=torch.zeros(8, dtype=dt, device=dev),
        t=torch.zeros((), dtype=dt, device=dev),
        step=torch.tensor(parity0, dtype=torch.int32, device=dev))
    state, _ = stepper_cuda.run_chunk_plain(tc.c, state, xs, parity0)
    return transpose_state(state, tc.NHL)


def _check(tc: TConsts, st: TState):
    import torch
    shapes = dict(a=(tc.MP, tc.NHL), b=(tc.MP, tc.NHL),
                  a_hs=(tc.MP, tc.NHL), b_hs=(tc.MP, tc.NHL),
                  hs_edge_a=(tc.NHP,), hs_edge_b=(tc.NHP,))
    tensors = {**{k: getattr(st, k) for k in shapes},
               "a0": tc.a0, "a0_ghost": tc.a0_ghost, "phi": tc.phi}
    shapes.update(a0=(tc.MP, tc.NHL), a0_ghost=(tc.MP, tc.NHL),
                  phi=(tc.MP, 1))
    dev = st.a.device
    for name, t in tensors.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shapes[name] or not t.is_contiguous()):
            raise ValueError(
                f"transposed kernel: {name} must be a contiguous float32 "
                f"{shapes[name]} tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return tensors


def run_chunk(tc: TConsts, st: TState, xs, parity0) -> TState:
    """len(xs) steps from a packed xs table: the kernel (two launches per
    step, the state updated in place) on CUDA tensors, the plain version
    on CPU tensors."""
    import torch
    dev = st.a.device
    if dev.type == "cpu":
        return run_chunk_plain(tc, st, xs, parity0)
    if dev.type != "cuda":
        raise ValueError(f"transposed kernel: unsupported device {dev}")
    t = _check(tc, st)
    n = xs.shape[0]
    if n < 1:
        raise ValueError("transposed kernel: an empty xs table")
    from ..ops import _build
    from ..ops.stepper_cuda import XS_LANES
    if xs.shape[1] != XS_LANES:
        raise ValueError(f"transposed kernel: xs must have {XS_LANES} lanes")
    lib = _build.load()
    params = np.ascontiguousarray(tc.params, np.float32)
    with torch.cuda.device(dev):
        xs_dev = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(
            dev)
        rc = lib.cdll.slb_transposed_chunk_f32(
            *(t[k].data_ptr() for k in ("a", "b", "a_hs", "b_hs",
                                        "hs_edge_a", "hs_edge_b", "a0",
                                        "a0_ghost", "phi")),
            params.ctypes.data, xs_dev.data_ptr(), tc.N, tc.M, tc.NHP,
            tc.MP, tc.NHL, n, int(parity0),
            torch.cuda.current_stream(dev).cuda_stream)
    # xs_dev may be freed before its launches run: the caching allocator
    # hands its memory only to later work on this stream
    if rc != 0:
        raise RuntimeError(f"transposed kernel launch failed: cudaError_t "
                           f"{rc}")
    global launch_count
    launch_count += LAUNCHES_PER_STEP * n
    return st


def setup(device, n_harmonics=100, g_grid=4000, NHL=NHL, steps=K):
    """(model, StencilConsts, TConsts, bootstrap State, xs table of
    `steps` rows) at BASELINE #4's physics, float32, av off: the table is
    ops/stepper_cuda.py:build_xs_table's fast-mode one from t=0."""
    import torch
    from ..config import SimConfig
    from ..models.superlattice import SuperlatticeModel
    from ..ops import stencil, stepper_cuda
    cfg = SimConfig(display=4, t_start=10.0, n_harmonics=n_harmonics,
                    g_grid=g_grid, dtype="f32", **PHYS)
    model = SuperlatticeModel(cfg)
    dev = torch.device(device)
    c = stencil.consts_from_model(model, dev)
    tc = transposed_consts(c, model, NHL)
    host = types.SimpleNamespace(**dict(zip(stepper_cuda.SCALAR_FIELDS,
                                            tc.params)))
    xs = stepper_cuda.build_xs_table(model, host, 0.0, 0, steps,
                                     av_enabled=False, exact=False)
    return model, c, tc, stencil.bootstrap_state(c, model), xs


def run(device, n_harmonics=100, g_grid=4000, NHL=NHL, K=K, timed=3):
    """The main path: K steps from the bootstrap state through the
    transposed kernel and through B1 (av off, in the form its plan picks:
    at BASELINE #4 the resident form, one launch), the two states held
    bit for bit, then µs per step of both (one warm-up and `timed` timed
    calls each)."""
    import torch
    from ..ops import stepper_cuda
    model, c, tc, state0, xs = setup(device, n_harmonics, g_grid, NHL, K)
    b1 = stepper_cuda.make_cuda_runner(c, model, av_enabled=False)
    st = run_chunk(tc, transpose_state(state0, NHL), xs, 0)
    ref = b1(state0.clone(), K)
    got = untranspose(st, model.NHP)
    for f, v in got.items():
        if not torch.equal(v, getattr(ref, f)):
            raise RuntimeError(f"transposed kernel: {f} after {K} steps is "
                               f"not B1's bit for bit")
    t_state, b_state = transpose_state(state0, NHL), state0.clone()
    t_ms = time_ms(lambda: run_chunk(tc, t_state, xs, 0), device, timed)
    b1_ms = time_ms(lambda: b1.run_xs(b_state, _xs_dict(xs), 0), device,
                    timed)
    return dict(N=model.N, M=model.M, NHP=model.NHP, MP=model.MP, NHL=NHL,
                K=K, us_per_step=t_ms * 1e3 / K,
                b1_us_per_step=b1_ms * 1e3 / K)


def kernel_us(device, n_harmonics=100, g_grid=4000, NHL=NHL, steps=200):
    """Device µs per launch of each kernel over one chunk of `steps` steps
    on the transposed kernel and on B1 (av off), by torch.profiler after a
    warm-up chunk: {kernel: µs}.  Needs a card."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..ops import stepper_cuda
    from ..profile_step import _device_us
    model, c, tc, state0, xs = setup(device, n_harmonics, g_grid, NHL, steps)
    b1 = stepper_cuda.make_cuda_runner(c, model, av_enabled=False)
    st, bs = transpose_state(state0, NHL), state0.clone()
    run_chunk(tc, st, xs, 0)                    # warm-up
    b1.run_xs(bs, _xs_dict(xs), 0)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_chunk(tc, st, xs, 0)
        b1.run_xs(bs, _xs_dict(xs), 0)
        torch.cuda.synchronize(device)
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(t_half_step|half_step|av_step|resident_chunk)"
                      r"<([^>]*)>", e.key)
        if m and e.count and _device_us(e) > 0:
            out[f"{m.group(1)}<{m.group(2)}>"] = _device_us(e) / e.count
    return out


def _xs_dict(xs):
    """A packed table's columns as the runners' run_xs takes them."""
    names = ("cos_t", "cos_t_dt", "cos_hs", "cos_hs_dt", "cos_av",
             "sin_av", "do_av", "t")
    return {k: xs[:, i] for i, k in enumerate(names)}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not have_card():
        return 1
    from ..bench import device_line
    steps = int(argv[0]) if argv else K
    card = device_line()
    res = run("cuda:0", K=steps)
    launches = launch_count
    per_kernel = kernel_us("cuda:0")
    print(f"transposed kernel: {res['us_per_step']:.4f} us/step, B1 (av "
          f"off) {res['b1_us_per_step']:.4f} us/step; N={res['N']} "
          f"M={res['M']} (MP={res['MP']}, NHL={res['NHL']}) float32, "
          f"{steps} steps, states bit for bit [{card}]")
    print("device us per launch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_kernel.items()))
    print(json.dumps({"probe": "P3 transposed_experiment", "device": card,
                      **res, "kernel_us": per_kernel,
                      "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
