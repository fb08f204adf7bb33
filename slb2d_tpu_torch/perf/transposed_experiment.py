"""P3 on the card: the step kernel B1's step in the transposed (m, n)
layout (csrc/probe_transposed.cu).

The port of tests/perf/transposed_experiment.py's Pallas probe
``_kernel_T``: the state arrays are (MP, NHL), m on the slow axis and the
harmonic n on the fast one, padded from NHP to NHL columns (NHL=128 at
N=100: 104 live, 23% more elements).  Each step is B1's with av off (the
main half-step, the parity ghost fill, the half-grid half-step against
the new main arrays, the stale row M+1 of the half-step arrays), in
either of B1's two forms, chosen by name (``form=``):

  resident        one cooperative launch per chunk, one block per SM,
                  each holding a band of R rows of the state in shared
                  memory (``resident_plan``), one grid barrier a step:
                  B1's resident form in this layout
  per-half-step   two launches per step, the state in device memory

Deliberate difference from the JAX probe: that kernel restores a
one-step-old edge column instead of B1's two-step rotation and hard-codes
BASELINE #4's physics scalars ("perf experiment only").  This one
computes B1's real step with the model's scalars, so its state,
transposed back, equals B1's plain version (ops/stepper_cuda.py:
run_chunk_plain, av off) bit for bit, and its time compares like with
like against B1's.

    python -m slb2d_tpu_torch.perf.transposed_experiment [K]

runs K=1000 steps at BASELINE #4 (N=100, M=4000, float32) on both forms
and on both forms of B1 (av off) from one state, checks every state bit
for bit, prints µs per step of the four in turns, the fixed cost of a
step of both resident forms at N=7 M=4000, what each form takes on the
card, each kernel's device µs per launch (torch.profiler) and one JSON
line.  It needs a card (main() refuses the CPU).  ``run_chunk`` launches
the kernel on CUDA tensors and runs the plain version,
``run_chunk_plain``, on CPU tensors; nothing falls back: a resident form
that no plan holds, or that the card cannot run at once, raises.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import types
from typing import NamedTuple

import numpy as np

from ..ops.stepper_cuda import (HALO_HALF, HALO_MAIN, NOT_CO_RESIDENT,
                                RESIDENT_BLOCK, SM_COUNT, SMEM_LIMIT,
                                XS_LANES, XS_STAGE, card_sms)
from . import have_card, time_ms

NHL = 128
K = 1000
FORMS = ("resident", "per-half-step")
# the per-half-step form's launches per step (t_half_step<true>,
# t_half_step<false>); the resident form's per chunk
LAUNCHES_PER_STEP = 2
LAUNCHES_PER_CHUNK = 1
# BASELINE #4 (BASELINE.md #4): the flagship display-4 run's physics and
# grid
PHYS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
            phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3)

# The resident form's budget beside B1's (SMEM_LIMIT, HALO_MAIN,
# HALO_HALF, XS_STAGE, RESIDENT_BLOCK, NOT_CO_RESIDENT, which it shares;
# csrc/probe_transposed.cu, whose constants of the same names
# tests/test_torch_probes_resident.py holds to these): a band's rows in
# units of ROW_ALIGN up to MAX_ROWS; the rows a band publishes per step;
# the tables of each row's mu parts.
ROW_ALIGN = 2
MAX_ROWS = 512
T_XCH_ROWS = 8
MU_TABLES = 4

# kernel launches made in this process, in all and per form
launch_count = 0
resident_launch_count = 0
per_half_step_launch_count = 0


class TPlan(NamedTuple):
    R: int            # rows of a band (the last band may have fewer)
    bands: int        # ceil(MP / R): blocks of the launch, one per SM
    smem_bytes: int   # dynamic shared memory a block
    threads: int      # threads a block


def resident_smem_bytes(NHL: int, R: int) -> int:
    """The dynamic shared memory of a band of R rows: a, b with HALO_MAIN
    rows on each side, a_hs, b_hs with HALO_HALF, XS_STAGE + 1 rows of the
    xs table, the rows' phi and MU_TABLES tables (float32)."""
    return 4 * (2 * (R + 2 * HALO_MAIN) * NHL + 2 * (R + 2 * HALO_HALF) * NHL
                + (XS_STAGE + 1) * XS_LANES
                + (MU_TABLES + 1) * (R + 2 * HALO_MAIN))


def resident_threads(NHL: int, R: int) -> int:
    """The plan's threads a block: NHL lanes (lane n holds column n) times
    min(R, RESIDENT_BLOCK // NHL) row groups.  The kernel takes any whole
    number of row groups up to that (a TPlan with fewer threads)."""
    return NHL * min(R, RESIDENT_BLOCK // NHL)


def resident_plan(NHP: int, MP: int, NHL: int = NHL, sms: int = SM_COUNT):
    """The resident form's TPlan for an (MP, NHL) state on a card of `sms`
    SMs, or None where it cannot hold the state: the fewest rows R, a
    multiple of ROW_ALIGN up to MAX_ROWS, that need at most `sms` bands
    whose arrays, halo, table rows and mu tables fit SMEM_LIMIT.  More rows
    need more shared memory, so where the fewest do not fit none do.
    BASELINE #4 (MP=4096, NHL=128): 128 bands of 32 rows, 73,680 bytes
    and 1024 threads a block."""
    if NHP < 2 or NHL < NHP or NHL % 4 or NHL > RESIDENT_BLOCK or MP < 2:
        return None
    for R in range(ROW_ALIGN, MAX_ROWS + 1, ROW_ALIGN):
        bands = -(-MP // R)
        if bands > sms or MP - (bands - 1) * R < 2:
            continue
        smem = resident_smem_bytes(NHL, R)
        if smem > SMEM_LIMIT:
            return None
        return TPlan(R, bands, smem, resident_threads(NHL, R))
    return None


def form_info(plan: TPlan, NHP: int, MP: int, NHL: int = NHL) -> dict:
    """What each form takes on the current card: the resident form with
    `plan`'s bands (registers and local bytes a thread, dynamic and static
    shared memory and threads a block, blocks at once on the card) and
    the per-half-step form's two kernels (registers, local bytes, static
    shared memory, threads a block).  Builds the kernels; needs a card."""
    import ctypes
    from ..ops import _build
    lib = _build.load().cdll
    out = (ctypes.c_int * 7)()
    rc = lib.slb_transposed_resident_info(plan.R, NHP, MP, NHL, plan.threads,
                                          ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"transposed kernel resident form query (R="
                           f"{plan.R}) failed: cudaError_t {rc}")
    res = dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
               blocks_at_once=out[3], threads=out[4],
               static_smem_bytes=out[5])
    rc = lib.slb_transposed_step_info(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"transposed kernel per-half-step form query "
                           f"failed: cudaError_t {rc}")
    per = {half: dict(registers=out[3 * k], local_bytes=out[3 * k + 1],
                      static_smem_bytes=out[3 * k + 2], threads=out[6])
           for k, half in enumerate(("t_half_step<true>",
                                     "t_half_step<false>"))}
    return {"resident": res, "per-half-step": per}


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


def run_chunk(tc: TConsts, st: TState, xs, parity0, form="resident",
              plan: TPlan | None = None) -> TState:
    """len(xs) steps from a packed xs table on CUDA tensors, the state
    updated in place, in the form named: "resident" (one cooperative
    launch; `plan`, or resident_plan on this card, must hold the state) or
    "per-half-step" (two launches per step).  On CPU tensors the plain
    version, whatever the form."""
    import torch
    if form not in FORMS:
        raise ValueError(f"transposed kernel: form must be one of {FORMS}, "
                         f"got {form!r}")
    dev = st.a.device
    if dev.type == "cpu":
        return run_chunk_plain(tc, st, xs, parity0)
    if dev.type != "cuda":
        raise ValueError(f"transposed kernel: unsupported device {dev}")
    t = _check(tc, st)
    n = xs.shape[0]
    if n < 1:
        raise ValueError("transposed kernel: an empty xs table")
    if xs.shape[1] != XS_LANES:
        raise ValueError(f"transposed kernel: xs must have {XS_LANES} lanes")
    if form == "resident" and plan is None:
        plan = resident_plan(tc.NHP, tc.MP, tc.NHL, card_sms(dev))
        if plan is None:
            raise ValueError(f"transposed kernel: no resident plan holds "
                             f"MP={tc.MP}, NHL={tc.NHL} on this card")
    from ..ops import _build
    lib = _build.load()
    params = np.ascontiguousarray(tc.params, np.float32)
    ptrs = [t[k].data_ptr() for k in ("a", "b", "a_hs", "b_hs", "hs_edge_a",
                                      "hs_edge_b", "a0", "a0_ghost", "phi")]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        xs_dev = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(
            dev)
        if form == "resident":
            xch = torch.zeros(2 * plan.bands * T_XCH_ROWS * tc.NHL,
                              dtype=torch.float32, device=dev)
            rc = lib.cdll.slb_transposed_resident_f32(
                *ptrs, params.ctypes.data, xs_dev.data_ptr(),
                xch.data_ptr(), tc.N, tc.M, tc.NHP, tc.MP, tc.NHL, plan.R,
                plan.threads, n, int(parity0), stream)
        else:
            rc = lib.cdll.slb_transposed_chunk_f32(
                *ptrs, params.ctypes.data, xs_dev.data_ptr(), tc.N, tc.M,
                tc.NHP, tc.MP, tc.NHL, n, int(parity0), stream)
    # xs_dev and xch may be freed before the launches run: the caching
    # allocator hands their memory only to later work on this stream
    if rc == NOT_CO_RESIDENT:
        raise RuntimeError(f"transposed kernel: the card cannot run the "
                           f"{plan.bands} bands of {plan} at once")
    if rc != 0:
        raise RuntimeError(f"transposed kernel ({form}) launch failed: "
                           f"cudaError_t {rc}")
    global launch_count, resident_launch_count, per_half_step_launch_count
    if form == "resident":
        launch_count += LAUNCHES_PER_CHUNK
        resident_launch_count += LAUNCHES_PER_CHUNK
    else:
        launch_count += LAUNCHES_PER_STEP * n
        per_half_step_launch_count += LAUNCHES_PER_STEP * n
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


def _runners(tc, c, model, xs):
    """{name: fn(state) -> state}: K = len(xs) steps of each form of P3 (on
    a TState) and of B1 with av off (on a stencil.State)."""
    from ..ops import stepper_cuda
    xd = _xs_dict(xs)
    b1 = {form: stepper_cuda.make_cuda_runner(c, model, av_enabled=False,
                                              form=form) for form in FORMS}
    fns = {f"P3 {form}": (lambda st, form=form: run_chunk(tc, st, xs, 0,
                                                          form=form))
           for form in FORMS}
    fns.update({f"B1 {form}": (lambda st, form=form: b1[form].run_xs(
        st, xd, 0)) for form in FORMS})
    return fns


def turns_us(device, fns, states, n_steps, timed):
    """{name: [µs per step]}: each fn timed twice in mirrored turns (a, b,
    ..., b, a), each turn one warm-up and `timed` timed calls."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        ms = time_ms(lambda: fns[k](states[k]), device, timed)
        out[k].append(ms * 1e3 / n_steps)
    return out


def check_forms(tc, c, model, state0, xs):
    """Each form of P3 and of B1 (av off) over len(xs) steps from state0:
    every P3 state, transposed back, equals B1's per-half-step form's bit
    for bit, and so does B1's resident form.  Returns the four states
    (P3's transposed back)."""
    import torch
    fns = _runners(tc, c, model, xs)
    got = {}
    for name, fn in fns.items():
        if name.startswith("P3"):
            got[name] = untranspose(fn(transpose_state(state0, tc.NHL)),
                                    tc.NHP)
        else:
            st = fn(state0.clone())
            got[name] = {f: getattr(st, f) for f in
                         ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b")}
    ref = got["B1 per-half-step"]
    for name, st in got.items():
        for f, v in st.items():
            if not torch.equal(v, ref[f]):
                raise RuntimeError(f"{name}: {f} after {len(xs)} steps is not "
                                   f"B1 per-half-step's bit for bit")
    return got


def run(device, n_harmonics=100, g_grid=4000, NHL=NHL, K=K, timed=3):
    """The main path: K steps from the bootstrap state through both forms
    of the transposed kernel and both forms of B1 (av off), every state
    held bit for bit (check_forms), then µs per step of the four in turns
    (one warm-up and `timed` timed calls a turn)."""
    model, c, tc, state0, xs = setup(device, n_harmonics, g_grid, NHL, K)
    check_forms(tc, c, model, state0, xs)
    fns = _runners(tc, c, model, xs)
    states = {k: (transpose_state(state0, NHL) if k.startswith("P3")
                  else state0.clone()) for k in fns}
    t = turns_us(device, fns, states, K, timed)
    mean = {k: sum(v) / len(v) for k, v in t.items()}
    plan = resident_plan(model.NHP, model.MP, NHL, card_sms(device))
    return dict(N=model.N, M=model.M, NHP=model.NHP, MP=model.MP, NHL=NHL,
                K=K, plan=plan._asdict() if plan else None, us_turns=t,
                us_per_step=mean["P3 resident"],
                us_per_step_per_half_step=mean["P3 per-half-step"],
                b1_us_per_step=mean["B1 resident"],
                b1_us_per_step_per_half_step=mean["B1 per-half-step"])


# the resident forms where the cells cost next to nothing (PERF.md §6,
# B1's fixed cost a step): N=7 M=4000, NHP=8, MP=4096; P3 at NHL=8 (256
# threads a block) and at NHL=32 (1024, B1's block there), 128 bands of 32
# rows
FIXED = dict(n_harmonics=7, g_grid=4000)
FIXED_NHLS = (8, 32)


def fixed_cost(device, K=2000, timed=3):
    """µs per step at FIXED of P3's resident form at each of FIXED_NHLS,
    P3's per-half-step form at the first and both forms of B1, in turns:
    the fixed cost of a step (the grid barrier with its halo exchange, the
    table rows; the per-half-step forms' launches), after check_forms over
    203 steps at each NHL."""
    fns, states = {}, {}
    for nhl in FIXED_NHLS:
        model, c, tc, state0, xs = setup(device, FIXED["n_harmonics"],
                                         FIXED["g_grid"], nhl, K)
        check_forms(tc, c, model, state0, xs[:203])
        run_fns = _runners(tc, c, model, xs)
        for k, fn in run_fns.items():
            if k.startswith("P3") and (nhl == FIXED_NHLS[0]
                                       or k == "P3 resident"):
                fns[f"{k} NHL={nhl}"] = fn
                states[f"{k} NHL={nhl}"] = transpose_state(state0, nhl)
            elif k.startswith("B1") and nhl == FIXED_NHLS[0]:
                fns[k], states[k] = fn, state0.clone()
    return turns_us(device, fns, states, K, timed)


# the resident form's block sizes measured against each other: the plan's
# bands with fewer row groups (more rows a thread)
BLOCK_THREADS = (256, 512, 1024)


def block_us(device, K=1000, timed=3):
    """µs per step of P3's resident form with blocks of each of
    BLOCK_THREADS threads that the plan's bands take (the same bands, fewer
    row groups), at BASELINE #4 (NHL=128) and at FIXED with NHL=32, in
    turns; each state first held bit for bit over 203 steps to the plan's
    block's.  {"shape threads=t": [µs per step]}."""
    import torch
    out = {}
    for name, (n_h, g_grid, nhl) in (("BASELINE#4", (100, 4000, NHL)),
                                     ("N=7 M=4000", (FIXED["n_harmonics"],
                                                     FIXED["g_grid"], 32))):
        model, c, tc, state0, xs = setup(device, n_h, g_grid, nhl, K)
        plan = resident_plan(model.NHP, model.MP, nhl, card_sms(device))
        plans = {t: plan._replace(threads=t) for t in BLOCK_THREADS
                 if t % nhl == 0 and t // nhl <= plan.R
                 and t <= plan.threads}
        ref = run_chunk(tc, transpose_state(state0, nhl), xs[:203], 0,
                        plan=plan)
        for t, p in plans.items():
            got = run_chunk(tc, transpose_state(state0, nhl), xs[:203], 0,
                            plan=p)
            for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
                if not torch.equal(getattr(got, f), getattr(ref, f)):
                    raise RuntimeError(f"transposed kernel at {name} with "
                                       f"{t} threads: {f} is not the plan's "
                                       f"bit for bit")
        fns = {f"{name} threads={t}": (
            lambda st, p=p: run_chunk(tc, st, xs, 0, plan=p))
            for t, p in plans.items()}
        states = {k: transpose_state(state0, nhl) for k in fns}
        out.update(turns_us(device, fns, states, K, timed))
    return out


def kernel_us(device, n_harmonics=100, g_grid=4000, NHL=NHL, steps=200):
    """Device µs per launch of each kernel over one chunk of `steps` steps
    on each form of the transposed kernel and of B1 (av off), by
    torch.profiler after a warm-up chunk: {kernel: µs}.  Needs a card."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from . import device_us
    model, c, tc, state0, xs = setup(device, n_harmonics, g_grid, NHL, steps)
    fns = _runners(tc, c, model, xs)
    states = {k: (transpose_state(state0, NHL) if k.startswith("P3")
                  else state0.clone()) for k in fns}
    for k, fn in fns.items():                  # warm-up
        fn(states[k])
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k, fn in fns.items():
            fn(states[k])
        torch.cuda.synchronize(device)
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(t_resident_chunk|t_half_step|half_step|av_step|"
                      r"resident_chunk)(<[^>]*>)?", e.key)
        if m and e.count and device_us(e) > 0:
            out[m.group(1) + (m.group(2) or "")] = device_us(e) / e.count
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
    launches = {"resident": resident_launch_count,
                "per-half-step": per_half_step_launch_count}
    fixed = fixed_cost("cuda:0")
    blocks = block_us("cuda:0")
    info = form_info(TPlan(**res["plan"]), res["NHP"], res["MP"], res["NHL"])
    per_kernel = kernel_us("cuda:0")
    print(f"transposed kernel, us per step in turns: " + "; ".join(
        f"{k} " + "/".join(f"{v:.4f}" for v in vs)
        for k, vs in res["us_turns"].items()) + f"; N={res['N']} "
        f"M={res['M']} (MP={res['MP']}, NHL={res['NHL']}) float32, {steps} "
        f"steps, every state bit for bit [{card}]")
    print("fixed cost a step at N=7 M=4000, us in turns: " + "; ".join(
        f"{k} " + "/".join(f"{v:.4f}" for v in vs) for k, vs in fixed.items()))
    print("resident form by threads a block, us per step in turns: "
          + "; ".join(f"{k} " + "/".join(f"{v:.4f}" for v in vs)
                      for k, vs in blocks.items()))
    print(f"forms on the card: {json.dumps(info)}")
    print("device us per launch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_kernel.items()))
    print(json.dumps({"probe": "P3 transposed_experiment", "device": card,
                      **res, "fixed_us_turns": fixed, "block_us_turns": blocks,
                      "forms": info,
                      "kernel_us": per_kernel, "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
