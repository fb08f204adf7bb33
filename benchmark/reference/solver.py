"""Plain PyTorch re-statement of the superlattice Boltzmann solver.

The benchmark's yardstick for what the program prints.  It is written
from the finite-difference equations of the reference C solver
(priimak/super-lattice-boltzmann-2d, src/boltzmann_c_solver.c; the model
of arXiv:1401.6047) and imports nothing of the program: it works out the
equilibrium a0, the time schedule, the state and the observables again
from the run's parameters alone.

What it keeps of the C solver, because the program keeps it too:

  * every scalar and every cell is rounded to the state's precision after
    each operation, in the C code's order (float32 for the f32 runs);
  * the four buffers rotate as in the C time loop, so the ghost cells of
    the first main buffer keep the initial a0 while the others stay zero;
  * the time t accumulates in the state's precision, `t += dt`, and the
    loop runs while t < t_max = t_start + T;
  * cos(omega t) is evaluated in float64 on the float32 product omega t
    and stored to float32;
  * averaging runs only while E_omega > 0 and t >= t_start.

What it does not keep: the C solver adds its sums over m one by one in
float32; here each term is rounded as in C and the sum is taken in
float64, which is closer to the exact sum.

A batch of points shares the grid (N, M, mu, alpha, PhiY, dt, t_start);
each point has its own E_dc, E_omega, omega and B, its own averaging
window and its own loop exit, and the values of each point are those of a
standalone display-4 run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# the reference C solver's literal for pi (src/constants.h:8)
PI = 3.141592653589793115998

f32 = np.float32
f64 = np.float64

# the display-4 line's columns, in the order the program prints them
D4_COLUMNS = ("E_dc", "E_omega", "omega", "mu", "v_dr_inst", "A", "norm",
              "v_y_inst", "m_inst", "v_dr_av", "v_y_av", "m_av", "Asin")
# the columns computed by the solver (the first four echo the input)
OBSERVABLES = D4_COLUMNS[4:]
# a display-77 line's columns (the last repeats A, under the header's Asin)
D77_COLUMNS = ("E_dc", "E_omega", "omega", "mu", "v_dr_inst", "A", "norm",
               "v_y_inst", "m_inst", "v_dr_av", "v_y_av", "m_av", "A_inst",
               "t", "A_again")
D77_OBSERVABLES = D77_COLUMNS[4:]


def bessel_in(n: int, x: float) -> float:
    """I_n(x) for integer n >= 0 and x > 0, by its power series summed
    in float64: sum_k (x/2)^(2k+n) / (k! (n+k)!)."""
    term = math.exp(n * math.log(x / 2.0) - math.lgamma(n + 1))
    q = x * x / 4.0
    total, k = term, 0
    while True:
        k += 1
        term *= q / (k * (n + k))
        if total + term == total:
            return total
        total += term


@dataclasses.dataclass(frozen=True)
class Grid:
    """The parameters a batch of points shares."""
    N: int
    M: int
    mu: float
    alpha: float
    phi_y_min: float
    phi_y_max: float
    dt: float
    t_start: float


def _np_dtype(dtype):
    """The numpy type whose rounding the host side of a run follows: the
    state's, or float32 for the narrow types numpy lacks (their values
    are rounded once more on the device)."""
    return f64 if dtype == torch.float64 else f32


def loop_times(t_start, omega, dt, D=f32):
    """(t, n_steps, t_max): the loop times t_0 = 0, t_{k+1} = D(t_k + dt)
    of `for (t = 0; t < t_max; t += dt)`, with t_max = D(t_start + T) and
    T = D(2 PI / omega), and the number of steps the loop makes."""
    omega, dt = D(omega), D(dt)
    T = D(2 * PI / f64(omega))
    t_max = D(D(t_start) + T)
    n = int(math.ceil(float(t_max) / float(dt) * 1.01)) + 16
    while True:
        seq = np.full(n + 1, dt, D)
        seq[0] = D(0)
        t = np.add.accumulate(seq, dtype=D)
        hits = np.flatnonzero(t >= t_max)
        if hits.size:
            return t[:hits[0] + 1], int(hits[0]), t_max
        n *= 2


def _cos(omega, t, D=f32):
    """D(cos(float64(D(omega * t)))) elementwise."""
    return np.cos(np.asarray(D(omega) * np.asarray(t, D), D).astype(f64)
                  ).astype(D)


class _Scalars:
    """The grid's derived scalars and arrays, rounded as the C code
    stores them (src/boltzmann_c_solver.c:87-122)."""

    def __init__(self, g: Grid, D):
        self.D = D
        self.N, self.M = g.N, g.M
        self.NS, self.MS = g.N + 1, g.M + 3
        self.dt = D(g.dt)
        self.mu, self.alpha = D(g.mu), D(g.alpha)
        self.dPhi = D(D(D(g.phi_y_max) - D(g.phi_y_min)) / D(g.M))
        self.nu = D(D(1) + D(self.dt / D(2)))
        self.nu2 = D(self.nu * self.nu)
        self.nu_tilde = D(D(1) - D(self.dt / D(2)))
        m = np.arange(self.MS)
        # phi_y(m) = PhiYmin + dPhi * (m - 1)
        self.phi = (D(g.phi_y_min)
                    + (self.dPhi * (m - 1).astype(D)).astype(D)).astype(D)
        mu64, al64 = f64(self.mu), f64(self.alpha)
        i0 = bessel_in(0, mu64)
        coef = [D(bessel_in(n, mu64) * (0.5 if n == 0 else 1.0) / (PI * i0)
                  * math.sqrt(mu64 / (2 * PI * al64)))
                for n in range(self.NS)]
        gauss = np.exp(-mu64 * self.phi.astype(f64) ** 2 / 2)
        self.a0 = (np.asarray(coef, f64)[:, None] * gauss[None, :]).astype(D)
        i1 = bessel_in(1, mu64)
        self.v_dr_mult = D(2 * i0 * PI * math.sqrt(al64) / i1)
        self.v_y_mult = D(4 * PI * i0 / i1)
        self.m_mult = D(PI * al64 * math.sqrt(al64))
        self.norm_mult = 2 * PI * math.sqrt(al64)


class _Batch:
    """The device side of a batch: the shared arrays and each point's
    scalars as (P, 1, 1) tensors."""

    def __init__(self, s: _Scalars, points, device, dtype):
        D = s.D
        P = len(points)
        dev = dict(device=device, dtype=dtype)
        col = lambda vals: torch.tensor(np.asarray(vals, f64),
                                        **dev).reshape(P, 1, 1)
        self.E_dc = col([D(p["E_dc"]) for p in points])
        self.E_omega = col([D(p["E_omega"]) for p in points])
        B = [D(p["B"]) for p in points]
        self.B = col(B)
        # bdt = B * dt / (4 * dPhi)
        self.bdt = col([D(D(b * s.dt) / D(D(4) * s.dPhi)) for b in B])
        self.dt_a0 = torch.tensor((s.dt * s.a0).astype(D).astype(f64),
                                  **dev)[:s.N]
        self.a0 = torch.tensor(s.a0.astype(f64), **dev)
        self.phi = torch.tensor(s.phi.astype(f64), **dev)
        self.n = torch.arange(s.N, **dev).reshape(1, s.N, 1)
        w = np.ones(s.N)
        w[0] = 0.0
        if s.N > 1:
            w[1] = 2.0
        self.w = torch.tensor(w, **dev).reshape(1, s.N, 1)
        self.scal = {k: torch.tensor(float(getattr(s, k)), **dev)
                     for k in ("dt", "nu", "nu2", "nu_tilde", "dPhi")}


def _stencil(s, bt, src_a, src_b, nb_a, nb_b, out_a, out_b, ct, ctd, m_hi):
    """One half-step of the C solver's step_on_grid (m_hi = M+1) or
    step_on_half_grid (m_hi = M) for every point: rows n = 0..N-1 and
    columns m = 1..m_hi of out are written, b's row 0 and every other
    cell are left as they are (src/boltzmann_c_solver.c:355-411).  ct and
    ctd: the (P, 1, 1) cos(omega t) and cos(omega (t + dt))."""
    N = s.N
    c = bt.scal
    m = slice(1, m_hi + 1)
    up = slice(2, m_hi + 2)
    dn = slice(0, m_hi)
    phi = bt.phi[m].reshape(1, 1, -1)
    bphi = bt.B * phi

    def coef(cos):
        # (E_dc + E_omega cos + B phi_y(m)) * dt / 2
        return ((bt.E_dc + bt.E_omega * cos) + bphi) * c["dt"] / 2

    mu_t = bt.n * coef(ct)
    mu_t1 = bt.n * coef(ctd)
    a_s = src_a[:, :N, m]
    b_s = src_b[:, :N, m]
    # b neighbours: rows n+1, and n-1 from n = 2 on
    db_up = nb_b[:, 1:N + 1, up] - nb_b[:, 1:N + 1, dn]
    db_dn = torch.zeros_like(db_up)
    db_dn[:, 2:] = nb_b[:, 1:N - 1, up] - nb_b[:, 1:N - 1, dn]
    g = (((bt.dt_a0[:, m] + a_s * c["nu_tilde"]) - b_s * mu_t)
         + bt.bdt * (db_up - db_dn))
    # a neighbours: rows n-1 from n = 1 on (twice at n = 1), and n+1
    da_dn = torch.zeros_like(db_up)
    da_dn[:, 1:] = nb_a[:, 0:N - 1, up] - nb_a[:, 0:N - 1, dn]
    h = ((b_s * c["nu_tilde"] + a_s * mu_t)
         + bt.bdt * ((bt.w * da_dn - nb_a[:, 1:N + 1, up])
                     + nb_a[:, 1:N + 1, dn]))
    xi = c["nu2"] + mu_t1 * mu_t1
    out_a[:, :N, m] = (g * c["nu"] - h * mu_t1) / xi
    out_b[:, 1:N, m] = ((g * mu_t1 + h * c["nu"]) / xi)[:, 1:]


def _sums(s, bt, a, b, hi):
    """(v_dr, v_y, m_x) of every point over m = 1..hi-1, each term rounded
    as in C (b dPhi; (a phi) dPhi; a dPhi), summed in float64; (P,)."""
    dphi = bt.scal["dPhi"]
    m = slice(1, hi)
    v_dr = (b[:, 1, m] * dphi).double().sum(-1)
    v_y = ((a[:, 0, m] * bt.phi[m]) * dphi).double().sum(-1)
    m_x = (a[:, 1, m] * dphi).double().sum(-1)
    return v_dr, v_y, m_x


def run_points(grid: Grid, points, device="cpu", dtype=torch.float32):
    """Run every point of the batch to its own loop exit, as a display-4
    run would; returns one dict a point, of D4_COLUMNS.

    points: dicts with E_dc, E_omega, omega and B.  dtype: the precision
    of the state and of every operation on it (float32 for the f32
    configurations; a lower one for the benchmark's control)."""
    D = _np_dtype(dtype)
    s = _Scalars(grid, D)
    P = len(points)
    bt = _Batch(s, points, device, dtype)
    dev = dict(device=device, dtype=dtype)

    # the host schedule: every point's loop times, exit and trig
    sched = [loop_times(grid.t_start, p["omega"], grid.dt, D)
             for p in points]
    n_steps = [n for _, n, _ in sched]
    steps = max(n_steps)
    t = sched[int(np.argmax(n_steps))][0][:steps]       # shared loop t
    dt = s.dt
    t1 = (t + dt).astype(D)
    t_hs = (t + D(dt / D(2))).astype(D)
    t_hs1 = (t_hs + dt).astype(D)
    trig = np.stack([np.stack([_cos(p["omega"], x, D)
                               for x in (t, t1, t_hs, t_hs1)], -1)
                     for p in points], 1)                # (steps, P, 4)
    trig = torch.tensor(trig.astype(f64), **dev)
    t_start = D(grid.t_start)
    live = np.arange(steps)[:, None] < np.asarray(n_steps)[None, :]
    gate = live & (t[:, None] >= t_start) & np.asarray(
        [D(p["E_omega"]) > 0 for p in points])[None, :]
    av_steps = np.flatnonzero(gate.any(1))
    gate_d = torch.tensor(gate, device=device)
    # av's cos and sin of omega t, in float64 on D(omega t)
    wt = np.stack([(D(p["omega"]) * t).astype(D).astype(f64)
                   for p in points], 1)
    av_trig = torch.tensor(np.stack([np.cos(wt), np.sin(wt)], -1),
                           device=device, dtype=torch.float64)
    exits = {}
    for i, n in enumerate(n_steps):
        exits.setdefault(n - 1, []).append(i)

    shape = (P, s.NS, s.MS)
    a = [torch.zeros(shape, **dev) for _ in range(4)]
    b = [torch.zeros(shape, **dev) for _ in range(4)]
    a[0][:] = bt.a0
    cur, nxt, ch, nh = 0, 1, 2, 3
    # the tiptoe to the first half step (:141-145): cos(0) and
    # cos(omega dt)
    one = torch.ones((P, 1, 1), **dev)
    c_dt = torch.tensor([_cos(p["omega"], dt, D).astype(f64)
                         for p in points], **dev).reshape(P, 1, 1)
    _stencil(s, bt, a[cur], b[cur], a[cur], b[cur], a[ch], b[ch], one, c_dt,
             s.M + 1)

    # av_data[0..5] of every point: the count, three running means and
    # the two quadratures
    count = torch.zeros(P, **dev)
    means = torch.zeros(3, P, **dev)
    quad = torch.zeros(2, P, **dev)
    final = torch.zeros(4, P, dtype=torch.float64, device=device)
    av_set = set(av_steps.tolist())
    for k in range(steps):
        tk = trig[k].reshape(P, 4, 1, 1)
        _stencil(s, bt, a[cur], b[cur], a[ch], b[ch], a[nxt], b[nxt],
                 tk[:, 0], tk[:, 1], s.M + 1)
        _stencil(s, bt, a[ch], b[ch], a[nxt], b[nxt], a[nh], b[nh],
                 tk[:, 2], tk[:, 3], s.M)
        if k in av_set:
            on = gate_d[k]
            v = _sums(s, bt, a[nxt], b[nxt], s.M + 1)
            n_new = count + 1
            for j in range(3):
                x = v[j].to(dtype)
                means[j] = torch.where(on, means[j] + (x - means[j]) / n_new,
                                       means[j])
            # d[4] += cos(omega t) v_dr dt, d[5] += sin(omega t) v_dr dt,
            # in float64
            step = av_trig[k].T * v[0].to(dtype).double() * float(dt)
            quad = torch.where(on, (quad.double() + step).to(dtype), quad)
            count = torch.where(on, n_new, count)
        if k in exits:
            # the display-4 line's instantaneous sums (m = 1..M-1) and the
            # norm (m = 1..M) of the points that leave the loop here
            idx = torch.tensor(exits[k], device=device)
            v = _sums(s, bt, a[nxt], b[nxt], s.M)
            nrm = (a[nxt][:, 0, 1:s.M + 1] * bt.scal["dPhi"]
                   ).double().sum(-1)
            got = torch.stack([v[0], v[1], v[2], nrm])
            final[:, idx] = got[:, idx]
        cur, nxt = nxt, cur
        ch, nh = nh, ch

    return _finish(s, points, sched, count, means, quad, final)


def _finish(s, points, sched, count, means, quad, final):
    """The display-4 columns of every point from its av_data and its
    loop-exit sums, scaled as the C solver does (:236-268)."""
    D = s.D
    means = means.double().cpu().numpy()
    quad = quad.double().cpu().numpy()
    final = final.cpu().numpy()
    out = []
    for i, p in enumerate(points):
        T = D(2 * PI / f64(D(p["omega"])))
        v_dr, v_y, m_x, nrm = (D(x) for x in final[:, i])
        out.append(dict(
            E_dc=D(p["E_dc"]), E_omega=D(p["E_omega"]), omega=D(p["omega"]),
            mu=s.mu,
            v_dr_inst=D(v_dr * s.v_dr_mult),
            A=D(D(D(quad[0, i]) * s.v_dr_mult) / T),
            norm=D(f64(nrm) * s.norm_mult),
            v_y_inst=D(v_y * s.v_y_mult),
            m_inst=D(m_x * s.m_mult),
            v_dr_av=D(D(means[0, i]) * s.v_dr_mult),
            v_y_av=D(D(means[1, i]) * s.v_y_mult),
            m_av=D(D(means[2, i]) * s.m_mult),
            Asin=D(D(D(quad[1, i]) * s.v_dr_mult) / T)))
    return out


def run_series(grid: Grid, point, device="cpu", dtype=torch.float32):
    """One display-77 run of `point` (E_dc, E_omega, omega, B): the
    time-series lines, one dict of D77_COLUMNS a line, in order.

    A line is due at each step whose frame_time, which adds dt a step and
    restarts from 0 after each line, has reached 0.01; averaging runs at
    those steps only (with the arrays after the step).  The line holds the
    sums of the arrays before the step, the averages after it, and the
    step's loop t; the quadratures are divided by t (the GPU driver's
    display 77, src/boltzmann_solver.c:412-445, without its in-place
    scaling of the running averages)."""
    D = _np_dtype(dtype)
    s = _Scalars(grid, D)
    bt = _Batch(s, [point], device, dtype)
    dev = dict(device=device, dtype=dtype)
    t, steps, _ = loop_times(grid.t_start, point["omega"], grid.dt, D)
    t = t[:steps]
    dt = s.dt
    trig = np.stack([_cos(point["omega"], x, D) for x in (
        t, (t + dt).astype(D), (t + D(dt / D(2))).astype(D),
        ((t + D(dt / D(2))).astype(D) + dt).astype(D))], -1)
    trig = torch.tensor(trig.astype(f64), **dev)
    wt = (D(point["omega"]) * t).astype(D).astype(f64)
    # the steps that print a line
    due, ft, thresh = [], D(0), D(0.01)
    emit = D(point["E_omega"]) > 0
    for k in range(steps):
        if emit and ft >= thresh:
            due.append(k)
            ft = D(0)
        ft = D(ft + dt)
    shape = (1, s.NS, s.MS)
    a = [torch.zeros(shape, **dev) for _ in range(4)]
    b = [torch.zeros(shape, **dev) for _ in range(4)]
    a[0][:] = bt.a0
    cur, nxt, ch, nh = 0, 1, 2, 3
    one = torch.ones((1, 1, 1), **dev)
    c_dt = torch.tensor(float(_cos(point["omega"], dt, D)), **dev).reshape(
        1, 1, 1)
    _stencil(s, bt, a[cur], b[cur], a[cur], b[cur], a[ch], b[ch], one, c_dt,
             s.M + 1)
    count = torch.zeros(1, **dev)
    means = torch.zeros(3, 1, **dev)
    quad = torch.zeros(2, 1, **dev)
    rows = []
    due_set = set(due)
    dphi = bt.scal["dPhi"]
    for k in range(steps):
        tk = trig[k].reshape(1, 4, 1, 1)
        if k in due_set:
            pre = _sums(s, bt, a[cur], b[cur], s.M + 1)
            nrm = (a[cur][:, 0, 1:s.M + 1] * dphi).double().sum(-1)
        _stencil(s, bt, a[cur], b[cur], a[ch], b[ch], a[nxt], b[nxt],
                 tk[:, 0], tk[:, 1], s.M + 1)
        _stencil(s, bt, a[ch], b[ch], a[nxt], b[nxt], a[nh], b[nh],
                 tk[:, 2], tk[:, 3], s.M)
        if k in due_set:
            v = _sums(s, bt, a[nxt], b[nxt], s.M + 1)
            count = count + 1
            for j in range(3):
                x = v[j].to(dtype)
                means[j] = means[j] + (x - means[j]) / count
            cs = torch.tensor([np.cos(wt[k]), np.sin(wt[k])],
                              dtype=torch.float64, device=device)
            quad = (quad.double()
                    + cs[:, None] * v[0].to(dtype).double() * float(dt)
                    ).to(dtype)
            got = torch.cat([torch.stack(pre + (nrm,)).reshape(-1),
                             means.double().reshape(-1),
                             quad.double().reshape(-1)])
            rows.append((k, got))
        cur, nxt = nxt, cur
        ch, nh = nh, ch
    return [_line(s, point, t[k], got.cpu().numpy()) for k, got in rows]


def _line(s, p, t, v):
    """One display-77 line from the pre-step sums (v_dr, v_y, m_x, norm),
    the post-step means and quadratures, and the loop t."""
    D = s.D
    v_dr, v_y, m_x, nrm = (D(x) for x in v[:4])
    t = D(t)
    v_dr_i = D(v_dr * s.v_dr_mult)
    A = D(D(D(v[7]) * s.v_dr_mult) / t)
    return dict(
        E_dc=D(p["E_dc"]), E_omega=D(p["E_omega"]), omega=D(p["omega"]),
        mu=s.mu, v_dr_inst=v_dr_i, A=A,
        norm=D(f64(nrm) * s.norm_mult),
        v_y_inst=D(v_y * s.v_y_mult), m_inst=D(m_x * s.m_mult),
        v_dr_av=D(D(v[4]) * s.v_dr_mult), v_y_av=D(D(v[5]) * s.v_y_mult),
        m_av=D(D(v[6]) * s.m_mult),
        A_inst=f64(np.cos(f64(D(D(p["omega"]) * t)))) * f64(v_dr_i),
        t=t, A_again=A)
