"""The semi-implicit leapfrog stencil as plain PyTorch tensor code.

The same branch-free formulation as ``slb2d_tpu/ops/stencil.py``: the
n=0 / n=1 special cases are data (mask and weight vectors), shifts
(n±1, m±1) are ``torch.roll``s whose wrap-around lands only in
masked-out ghost rows/columns.  This is the ``impl=torch`` engine and the
plain reference beside the CUDA kernel (``ops/stepper_cuda.py``).

Every function also takes a leading point axis, where the JAX package
vmaps over sweep points (parallel/sweep.py): state arrays (B, NHP, MP),
edges (B, NHP), av (B, 8), t and step (B,), and per-point scalars as
(B, 1, 1) tensors.  Shifts roll the last two dims and row reads take
``[..., n, :]``, so one code path serves a single run (no point axis)
and a batch.

Update scheme per grid point and harmonic (src/boltzmann_c_solver.c:363-378):

    mu_t   = n * (E_dc + E_omega*cos(w t)      + B*phi_y) * dt/2
    mu_t1  = n * (E_dc + E_omega*cos(w (t+dt)) + B*phi_y) * dt/2
    g = dt*a0 + a*nu_tilde - b*mu_t
        + bdt*( b~[n+1,m+1] - b~[n+1,m-1] - [n>=2]*(b~[n-1,m+1] - b~[n-1,m-1]) )
    h = b*nu_tilde + a*mu_t
        + bdt*( w_n*(a~[n-1,m+1] - a~[n-1,m-1]) - a~[n+1,m+1] + a~[n+1,m-1] )
    xi = nu2 + mu_t1^2
    a' = (g*nu - h*mu_t1)/xi ;  b' = (g*mu_t1 + h*nu)/xi   (b' only for n>0)

where ~ marks the time-staggered neighbor arrays and w_n = [0, 2, 1, 1, ...].

Buffer-staleness quirks of the reference's 4-buffer rotation are reproduced
so float32 runs pin against the C solver:
  * the half-step writes only m=1..M, so column M+1 of the half-step arrays
    alternates between its bootstrap value and 0 — carried here as the
    `hs_edge_*` vectors;
  * main-grid harmonic row N alternates between a0[N] and 0 but is never
    read by the dynamics; output code reconstructs it from the step parity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class State:
    """Full solver state at one main-grid time (field order and meaning as
    ``slb2d_tpu.ops.stencil.State``)."""
    a: torch.Tensor          # (NHP, MP) cosine harmonics, main grid
    b: torch.Tensor          # (NHP, MP) sine harmonics, main grid
    a_hs: torch.Tensor       # (NHP, MP) half-step grid
    b_hs: torch.Tensor
    hs_edge_a: torch.Tensor  # (NHP,) stale column M+1 for the next hs write
    hs_edge_b: torch.Tensor  # (NHP,)
    av: torch.Tensor         # (8,) running observables + Kahan compensations
                             # for av[4]/av[5] in [6]/[7]
    t: torch.Tensor          # 0-d, loop time (state dtype)
    step: torch.Tensor       # 0-d int32 number of completed steps

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "State":
        return State(**{f: getattr(self, f).clone() for f in FIELDS})


FIELDS = tuple(f.name for f in dataclasses.fields(State))


@dataclasses.dataclass
class StencilConsts:
    """Everything the stencil math reads besides the state, as tensors on
    one device."""
    a0: torch.Tensor           # (NHP, MP) equilibrium
    a0_ghost: torch.Tensor     # (NHP, MP) a0 on the never-rewritten ghost cells
    phi: torch.Tensor          # (MP,) phi_y values
    n_float: torch.Tensor      # (NHP, 1) float harmonic index
    row_update: torch.Tensor   # (NHP, 1) bool: n < N
    n_ge2: torch.Tensor        # (NHP, 1) float: 1.0 where n >= 2
    w_n: torch.Tensor          # (NHP, 1) float: 0/2/1 weights
    b_row_mask: torch.Tensor   # (NHP, 1) bool: n > 0
    col_main: torch.Tensor     # (1, MP) bool: 1 <= m <= M+1
    col_half: torch.Tensor     # (1, MP) bool: 1 <= m <= M
    w_av: torch.Tensor         # (MP,) dPhi over av bounds
    w_av_phi: torch.Tensor     # (MP,) dPhi*phi over av bounds
    # 0-d scalars
    E_dc: torch.Tensor
    E_omega: torch.Tensor
    omega: torch.Tensor
    B: torch.Tensor
    dt: torch.Tensor
    nu: torch.Tensor
    nu2: torch.Tensor
    nu_tilde: torch.Tensor
    bdt: torch.Tensor
    t_start: torch.Tensor
    t_end: torch.Tensor        # averaging window end (t_max); +inf normally
    col_edge: torch.Tensor     # (1, MP) bool one-hot at column M+1


def consts_from_model(model, device, t_start=None) -> StencilConsts:
    f = model.np_dtype

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    return StencilConsts(
        a0=dev(model.a0), a0_ghost=dev(model.a0_ghost), phi=dev(model.phi),
        n_float=dev(model.n_float),
        row_update=dev(model.row_update), n_ge2=dev(model.n_ge2),
        w_n=dev(model.w_n),
        b_row_mask=dev(model.b_row_mask), col_main=dev(model.col_main),
        col_half=dev(model.col_half), w_av=dev(model.w_av),
        w_av_phi=dev(model.w_av_phi),
        E_dc=dev(model.E_dc), E_omega=dev(model.E_omega),
        omega=dev(model.omega), B=dev(model.B), dt=dev(model.dt),
        nu=dev(model.nu), nu2=dev(model.nu2),
        nu_tilde=dev(model.nu_tilde), bdt=dev(model.bdt),
        t_start=dev(f(model.cfg.t_start if t_start is None else t_start)),
        t_end=dev(f(np.inf)),
        col_edge=dev(np.arange(model.MP)[None, :] == model.M + 1),
    )


def _shift(arr, dn: int, dm: int):
    """Value at (n+dn, m+dm); wrap-around lands only in masked positions."""
    return torch.roll(arr, shifts=(-dn, -dm), dims=(-2, -1))


def apply_half_step(c: StencilConsts, a_src, b_src, a_nb, b_nb,
                    cos_t, cos_t_dt, *, main: bool,
                    use_reciprocal: bool = False):
    """One stencil application.

    a_src/b_src are read pointwise at (n, m) (the arrays being advanced);
    a_nb/b_nb are the time-staggered arrays read at (n±1, m±1).
    `main=True` uses the main-grid write bounds m=1..M+1
    (src/boltzmann_c_solver.c:361), else the half-grid bounds m=1..M (:391).
    """
    # operand order mirrors the C expressions so float32 rounding matches
    mu_t_part = (c.E_dc + c.E_omega * cos_t + c.B * c.phi) * c.dt / 2
    mu_t1_part = (c.E_dc + c.E_omega * cos_t_dt + c.B * c.phi) * c.dt / 2
    mu_t = c.n_float * mu_t_part          # (NHP, MP)
    mu_t1 = c.n_float * mu_t1_part

    # shared m-difference: X[n, m] = nb[n, m+1] - nb[n, m-1]; the n±1 reads
    # are then single-axis shifts of it.  The exact form follows the C
    # expressions' associativity (g: fl(d1 - d2) with both differences
    # pre-formed, :370-371; h: fl(fl(W - a1) + a2) with the n+1 neighbors
    # subtracted INDIVIDUALLY, :372-373).  The use_reciprocal form reuses
    # dm_a for h's n+1 term — one association swap, sub-ulp
    # (docs/DEVIATIONS.md D7 class).
    dm_b = _shift(b_nb, 0, 1) - _shift(b_nb, 0, -1)
    dm_a = _shift(a_nb, 0, 1) - _shift(a_nb, 0, -1)
    g = (c.dt * c.a0 + a_src * c.nu_tilde - b_src * mu_t
         + c.bdt * (_shift(dm_b, 1, 0) - c.n_ge2 * _shift(dm_b, -1, 0)))
    if use_reciprocal:
        h_np1 = c.w_n * _shift(dm_a, -1, 0) - _shift(dm_a, 1, 0)
    else:
        h_np1 = (c.w_n * _shift(dm_a, -1, 0)
                 - _shift(a_nb, 1, 1) + _shift(a_nb, 1, -1))
    h = b_src * c.nu_tilde + a_src * mu_t + c.bdt * h_np1

    # Row masking folds into the nu factor: nu_a/nu_b are (NHP, 1)
    # vectors equal to nu at updated rows and 0 at n >= N (and n == 0 for
    # b), and n_float is zeroed there too, so mu_t1 vanishes — outputs at
    # masked rows are exactly 0.  Only the column select remains.
    dtype = a_src.dtype
    nu_a = c.nu * c.row_update.to(dtype)
    nu_b = nu_a * c.b_row_mask.to(dtype)
    xi = c.nu2 + mu_t1 * mu_t1
    cols = c.col_main if main else c.col_half
    if use_reciprocal:
        # one division + two multiplies instead of two divisions, with the
        # ghost-column mask folded in: colf/xi is 0 at ghost columns
        inv_xi = cols.to(dtype) / xi
        a_new = (g * nu_a - h * mu_t1) * inv_xi
        b_new = (g * mu_t1 + h * nu_b) * inv_xi
        return a_new, b_new
    a_new = (g * nu_a - h * mu_t1) / xi
    b_new = (g * mu_t1 + h * nu_b) / xi
    zero = torch.zeros((), dtype=dtype, device=a_new.device)
    a_new = torch.where(cols, a_new, zero)
    b_new = torch.where(cols, b_new, zero)
    return a_new, b_new


def tiptoe_half_step(c: StencilConsts, a, cos_wdt):
    """The bootstrap tiptoe (reference src/boltzmann_c_solver.c:141-145):
    one main-grid half-step reading the initial arrays for both roles."""
    b = torch.zeros_like(a)
    return apply_half_step(c, a, b, a, b, 1.0, cos_wdt, main=True)


def bootstrap_cos_wdt(model):
    """cos(omega*dt) through the reference's float->double->float
    rounding (src/boltzmann_c_solver.c:141's cos argument path)."""
    f = model.np_dtype
    return f(np.cos(np.float64(f(model.omega) * f(model.dt))))


def bootstrap_state(c: StencilConsts, model) -> State:
    """Initial state: a = a0, b = 0, plus the tiptoe first half-step
    (reference: src/boltzmann_c_solver.c:136-145)."""
    device = c.a0.device
    a = torch.as_tensor(model.initial_a(), device=device)
    b = torch.zeros_like(a)
    a_hs, b_hs = tiptoe_half_step(c, a, float(bootstrap_cos_wdt(model)))
    NHP = a.shape[0]
    return State(
        a=a, b=b, a_hs=a_hs, b_hs=b_hs,
        hs_edge_a=torch.zeros(NHP, dtype=a.dtype, device=device),
        hs_edge_b=torch.zeros(NHP, dtype=a.dtype, device=device),
        av=torch.zeros(8, dtype=a.dtype, device=device),
        t=torch.zeros((), dtype=a.dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def av_update(c: StencilConsts, av, a_new, b_new, cos_av, sin_av):
    """Running observable averages (reference: src/boltzmann_c_solver.c:413-437).

    av[0]: sample count; av[1..3]: incremental means of v_dr, v_y, m/m_x;
    av[4], av[5]: absorption quadratures Sum cos/sin(w t) * v_dr * dt with
    Kahan compensation carried in av[6], av[7].
    """
    v_dr = torch.sum(b_new[..., 1, :] * c.w_av, dim=-1)
    v_y = torch.sum(a_new[..., 0, :] * c.w_av_phi, dim=-1)
    m_x = torch.sum(a_new[..., 1, :] * c.w_av, dim=-1)
    return av_update_from_sums(c, av, v_dr, v_y, m_x, cos_av, sin_av)


def av_update_from_sums(c, av, v_dr, v_y, m_x, cos_av, sin_av):
    """av_update with the three raw grid sums precomputed.  With a point
    axis, the sums and cos_av/sin_av are (B,) and av is (B, 8)."""
    av = av.unbind(-1)
    count = av[0] + 1
    av1 = av[1] + (v_dr - av[1]) / count
    av2 = av[2] + (v_y - av[2]) / count
    av3 = av[3] + (m_x - av[3]) / count
    y4 = cos_av * v_dr * c.dt - av[6]
    t4 = av[4] + y4
    c4 = (t4 - av[4]) - y4
    y5 = sin_av * v_dr * c.dt - av[7]
    t5 = av[5] + y5
    c5 = (t5 - av[5]) - y5
    return torch.stack([av[0] + 1, av1, av2, av3, t4, t5, c4, c5], dim=-1)


def full_step(c: StencilConsts, state: State, trig, do_av, *,
              use_reciprocal: bool = False) -> State:
    """One full time step = main-grid + half-grid stencil application plus
    optional observable accumulation (reference loop body,
    src/boltzmann_c_solver.c:164-194).  trig: (cos_t, cos_t_dt, cos_hs,
    cos_hs_dt, cos_av, sin_av) as Python floats or 0-d tensors; with a
    point axis the first four may be (B, 1, 1) and the last two (B,).
    do_av: a bool, or a (B,) bool tensor gating each point's av.
    use_reciprocal selects apply_half_step's form (the kernel's)."""
    cos_t, cos_t_dt, cos_hs, cos_hs_dt, cos_av, sin_av = trig
    a_new, b_new = apply_half_step(
        c, state.a, state.b, state.a_hs, state.b_hs, cos_t, cos_t_dt,
        main=True, use_reciprocal=use_reciprocal)
    # Parity ghost fill: this step writes main buffer (step+1) % 2; buffer 0
    # keeps a0's ghost cells from the initial copy, buffer 1 keeps zeros.
    # a_new is zero outside the write region, so the add is exact.
    ghost_on = ((state.step + 1) % 2 == 0)[..., None, None]
    a_new = a_new + torch.where(ghost_on, c.a0_ghost,
                                torch.zeros((), dtype=a_new.dtype,
                                            device=a_new.device))
    ahs_new, bhs_new = apply_half_step(
        c, state.a_hs, state.b_hs, a_new, b_new, cos_hs, cos_hs_dt,
        main=False, use_reciprocal=use_reciprocal)
    # stale column M+1 of the retired half-step buffer (4-buffer rotation)
    emask = c.col_edge.to(a_new.dtype)
    ahs_new = torch.where(c.col_edge, state.hs_edge_a[..., None], ahs_new)
    bhs_new = torch.where(c.col_edge, state.hs_edge_b[..., None], bhs_new)
    # exact: a row dot with a one-hot mask picks the single column value
    new_edge_a = torch.sum(state.a_hs * emask, dim=-1)
    new_edge_b = torch.sum(state.b_hs * emask, dim=-1)
    if isinstance(do_av, torch.Tensor):
        av_new = torch.where(do_av[..., None], av_update(
            c, state.av, a_new, b_new, cos_av, sin_av), state.av)
    else:
        av_new = (av_update(c, state.av, a_new, b_new, cos_av, sin_av)
                  if do_av else state.av)
    return State(
        a=a_new, b=b_new, a_hs=ahs_new, b_hs=bhs_new,
        hs_edge_a=new_edge_a, hs_edge_b=new_edge_b,
        av=av_new, t=state.t + c.dt, step=state.step + 1)


def device_trig(c: StencilConsts, t):
    """Trig evaluated at array precision from the carried t (the fast
    mode's counterpart of the host schedule's double-evaluated cos)."""
    dt = c.dt
    t_hs = t + dt / 2
    return (
        torch.cos(c.omega * t),
        torch.cos(c.omega * (t + dt)),
        torch.cos(c.omega * t_hs),
        torch.cos(c.omega * (t_hs + dt)),
        torch.cos(c.omega * t),
        torch.sin(c.omega * t),
    )


def emission_record(c: StencilConsts, pre: State, post: State):
    """Raw per-step observables for batched display-77 emission: sums over
    the PRE-step arrays (the reference prints a[current], the pre-swap
    state, src/boltzmann_c_solver.c:182) plus the POST-step av_data and the
    step's loop t.  Host-side formatting applies the multipliers."""
    return torch.cat([
        torch.stack([
            torch.sum(pre.a[..., 0, :] * c.w_av, dim=-1),  # norm bounds
            torch.sum(pre.b[..., 1, :] * c.w_av, dim=-1),  # == av bounds
            torch.sum(pre.a[..., 0, :] * c.w_av_phi, dim=-1),
            torch.sum(pre.a[..., 1, :] * c.w_av, dim=-1),
            pre.t.to(pre.a.dtype)], dim=-1),
        post.av], dim=-1)


# the display-4 loop-exit capture's columns (csrc/sweep_stack.cu CAP_COLS)
CAP_KEYS = ("v_dr", "v_y", "m_x", "norm")


def capture_sums(state: State, w_d4, w_d4_phi, w_norm):
    """The display-4 loop-exit sums of every point's current arrays
    (src/boltzmann_c_solver.c:236-244), a (..., 4) tensor in CAP_KEYS
    order: b[1]·w_d4, a[0]·w_d4_phi, a[1]·w_d4, a[0]·w_norm."""
    return torch.stack([
        torch.sum(state.b[..., 1, :] * w_d4, dim=-1),
        torch.sum(state.a[..., 0, :] * w_d4_phi, dim=-1),
        torch.sum(state.a[..., 1, :] * w_d4, dim=-1),
        torch.sum(state.a[..., 0, :] * w_norm, dim=-1)], dim=-1)


def fast_step(c: StencilConsts, state: State, av_enabled: bool) -> State:
    """One full step with the trig evaluated on the device from the
    carried t (exact-time=0; the JAX package's make_step_fn with
    exact_trig=False): where av_enabled (the display policy), av is gated
    by E_omega > 0 (src/boltzmann_c_solver.c:188) and the window
    [t_start, t_end) on the device, with no host read."""
    do_av = ((c.E_omega > 0) & (state.t >= c.t_start) & (state.t < c.t_end)
             if av_enabled else False)
    return full_step(c, state, device_trig(c, state.t), do_av)


XS_TRIG = ("cos_t", "cos_t_dt", "cos_hs", "cos_hs_dt", "cos_av", "sin_av")


def run_chunk(c: StencilConsts, state: State, xs: dict, *,
              collect_obs: bool, exact_trig: bool = True,
              av_enabled: bool = True):
    """Advance len(xs["t"]) full steps over host schedule columns (from
    runtime/schedule.iter_chunks): the counterpart of the JAX package's
    make_step_fn + lax.scan.  exact_trig=False takes each step's trig and
    av gate from fast_step (av_enabled: the display policy) instead of
    the columns.  Returns (state, ys) where ys stacks one emission_record
    per step when collect_obs, else None."""
    cols = [np.asarray(xs[k]) for k in XS_TRIG]
    do_av = np.asarray(xs["do_av"])
    records = []
    for i in range(len(xs["t"])):
        if exact_trig:
            trig = tuple(float(col[i]) for col in cols)
            new = full_step(c, state, trig, bool(do_av[i]))
        else:
            new = fast_step(c, state, av_enabled)
        if collect_obs:
            records.append(emission_record(c, state, new))
        state = new
    return state, (torch.stack(records) if collect_obs else None)


def state_from_numpy(d: dict, device) -> State:
    """State from host arrays keyed by field name (e.g. a JAX State's
    fields through np.asarray)."""
    return State(**{k: torch.as_tensor(np.array(d[k]), device=device)
                    for k in FIELDS})


def state_to_numpy(state: State) -> dict:
    """Host copies of every state field, keyed by field name."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}
