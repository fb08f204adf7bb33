"""Host-side step schedule: exact emulation of the C driver's time loop.

The reference accumulates simulation time in float32 (`ffloat t`,
src/boltzmann_c_solver.c:164 `for(t = t0; t < t_max; t += dt)`) and gates
averaging/emissions on float32 comparisons, with trig evaluated in double
on float32 arguments.  The number of steps, every cos/sin value, and every
emission index are therefore pure functions of the config — precomputed
here on the host and fed to the device scan as `xs`, so the device loop
replays the C solver exactly without data-dependent control flow.

Emission kinds and their reference anchors:
  * "e77" — display 77 time-series line: av() with the post-step arrays,
    then print with the PRE-step arrays (:178-186); the emitting step is
    its own chunk so the driver still holds the pre-step state.
  * "e7"  — display 7 movie frame, post-step arrays (:196-204); the GPU
    driver additionally requires t > frame_start (src/boltzmann_solver.c:277)
    which we adopt (identical when frame_start=0).
  * "e9"  — display 9 strobe at drive-period wraparound, post-step arrays
    (src/boltzmann_solver.c:260-275; GPU-only display).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

f32 = np.float32
f64 = np.float64


@dataclasses.dataclass
class Chunk:
    """A run of consecutive steps executed as one device scan."""
    xs: dict                      # per-step arrays, each of length n_steps
    n_steps: int
    event: Optional[str]          # None | "e77" | "e7" | "e9"
    t_first: float                # loop t of the first step in the chunk
    t_last: float                 # loop t of the last step (event time)
    emit_idx: tuple = ()          # in-chunk indices of display-77 emissions
                                  # (batched-emission mode only)


def accum_sequence(t0, dt, n, dtype=f32):
    """[t0, D(t0+dt), D(D(t0+dt)+dt), ...] — n+1 values of the C driver's
    sequential `t += dt` accumulation at dtype.  np.add.accumulate is
    strictly sequential (unlike np.sum's pairwise reduction), so this is
    bit-identical to the scalar loop, at numpy speed."""
    arr = np.empty(n + 1, dtype)
    arr[0] = dtype(t0)
    arr[1:] = dtype(dt)
    return np.add.accumulate(arr, dtype=dtype)


def count_steps(t0, t_max, dt, dtype=f32) -> int:
    """Number of iterations of `for(t=t0; t<t_max; t+=dt)` at dtype."""
    if dtype is f32:
        from ..io.native import count_steps_f32
        n = count_steps_f32(float(t0), float(t_max), float(dt))
        if n is not None:
            return n
    t0 = dtype(t0)
    t_max = dtype(t_max)
    dt = dtype(dt)
    if not t0 < t_max:
        return 0
    # vectorized: build the accumulated-t sequence and find the first
    # value failing t < t_max
    guess = max(16, int((f64(t_max) - f64(t0)) / f64(dt) * 1.01) + 16)
    for _ in range(8):
        ts = accum_sequence(t0, dt, guess, dtype)
        hits = np.nonzero(ts >= t_max)[0]
        if hits.size:
            return int(hits[0])
        if ts[-1] == ts[-2]:
            raise RuntimeError(
                "t += dt stalls before t_max (float accumulation limit); "
                "the reference would loop forever here — increase dt")
        guess *= 4
    raise RuntimeError("count_steps: t_max unreachable")


def _frame_cadence(ft_nores, gate_from, dt, dtype, n):
    """Emission indices of the `frame_time >= 0.01` cadence with reset.

    ft_nores: the no-reset frame_time sequence (values BEFORE each step's
    trailing `frame_time += dt`), length >= n.  gate_from: first step index
    at which emission is allowed (0 normally; first index with
    t > frame_start for display 7 — the gate is monotone because t only
    grows).  Returns (indices array, final frame_time after step n-1).

    Key invariant making this vectorizable: after any emission frame_time
    restarts at exactly 0 (then +dt at that step's end), so the inter-
    emission stride is a constant — the length of the dt-accumulation from
    dt to >= 0.01 — computed once.
    """
    D = dtype
    thresh = D(0.01)
    if gate_from >= n:
        return np.empty(0, np.int64), float(ft_nores[n])
    cand = np.nonzero(ft_nores[gate_from:n] >= thresh)[0]
    if cand.size == 0:
        return np.empty(0, np.int64), float(ft_nores[n])
    first = gate_from + int(cand[0])
    # stride: steps from the post-reset value (dt) back up to >= 0.01
    limit = 4
    while True:
        seq = accum_sequence(dt, dt, limit, D)   # seq[j] = ft at offset j+1
        hits = np.nonzero(seq >= thresh)[0]
        if hits.size:
            stride = int(hits[0]) + 1
            break
        if seq[-1] == seq[-2]:
            # frame_time stalls below 0.01: only the first emission fires
            return (np.asarray([first], np.int64),
                    float(accum_sequence(0.0, dt, n - first, D)[-1]))
        limit *= 4
    idx = np.arange(first, n, stride, dtype=np.int64)
    # after the reset at idx[-1], dt is added at that step's end and at
    # each of the n-1-idx[-1] following steps
    ft_final = float(accum_sequence(0.0, dt, n - int(idx[-1]), D)[-1])
    return idx, ft_final


def iter_chunks(*, omega, dt, t0, t_max, t_start, E_omega, display,
                frame_start, T, dtype=f32, chunk_max=4096,
                frame_time0=0.0, last_tT_reminder0=0.0,
                av_always_off=False, carry_out: Optional[dict] = None,
                break_on_e77: bool = True) -> Iterator[Chunk]:
    """Yield the step schedule for one parameter-server round (vectorized).

    Semantics are exactly `iter_chunks_sequential` (the readable scalar
    emulation of the C time loop, kept below and cross-checked in
    tests/test_runtime.py); this builder computes the whole schedule with
    numpy array ops — sequential float accumulation via np.add.accumulate,
    trig over whole arrays — because the scalar version costs ~12 us/step
    of host time, which at flagship shapes rivals the device compute
    (VERDICT round 1, "the headline perf number is kernel-only").
    """
    D = dtype
    omega = D(omega)
    dt = D(dt)
    t0 = D(t0)
    t_max = D(t_max)
    t_start = D(t_start)
    T = D(T)
    e_om_pos = float(E_omega) > 0

    n = count_steps(t0, t_max, dt, D)
    ts = accum_sequence(t0, dt, n, D)        # ts[k]: loop t of step k;
                                             # ts[n]: the loop-exit t
    if n == 0:
        if carry_out is not None:
            carry_out["frame_time"] = float(frame_time0)
            carry_out["last_rem"] = float(last_tT_reminder0)
            carry_out["t_exit"] = float(t0)
        return

    # --- trig, all steps at once (bit-identical to the scalar path:
    # dtype multiply, double cos, dtype store) ---------------------------
    prod = (omega * ts).astype(D)
    cos_all = np.cos(prod.astype(f64)).astype(D)
    cos_t = cos_all[:n]
    cos_t_dt = cos_all[1:n + 1]              # trig(D(t+dt)) == trig(ts[k+1])
    t_hs = (ts[:n] + D(dt / 2)).astype(D)
    cos_hs = np.cos((omega * t_hs).astype(D).astype(f64)).astype(D)
    ths_dt = (t_hs + dt).astype(D)
    cos_hs_dt = np.cos((omega * ths_dt).astype(D).astype(f64)).astype(D)
    sin_av = np.sin(prod[:n].astype(f64)).astype(D)
    cos_av = cos_t                            # trig(t) again in the scalar

    # --- emission cadences ----------------------------------------------
    ft_nores = accum_sequence(frame_time0, dt, n, D)   # no-reset frame_time
    ft_final = float(ft_nores[n])
    last_rem_final = float(last_tT_reminder0)
    e77_idx = np.empty(0, np.int64)
    e7_idx = np.empty(0, np.int64)
    e9_idx = np.empty(0, np.int64)

    if display == 77 and e_om_pos:
        e77_idx, ft_final = _frame_cadence(ft_nores, 0, dt, D, n)
    elif display == 7:
        gated = np.nonzero(ts[:n] > D(frame_start))[0]
        if gated.size:
            e7_idx, ft_final = _frame_cadence(ft_nores, int(gated[0]),
                                              dt, D, n)
    elif display == 9 and float(T) > 0:
        live = np.nonzero(ts[:n] >= t_start)[0]
        if live.size:
            tT = (ts[live] / T).astype(D)
            rem = (tT - np.trunc(tT)).astype(D)
            prev = np.concatenate(([D(last_tT_reminder0)], rem[:-1]))
            e9_idx = live[rem < prev]
            last_rem_final = float(rem[-1])

    do_av = np.zeros(n, bool)
    if e_om_pos and display not in (7, 77, 8) and not av_always_off:
        do_av = ts[:n] >= t_start
    if e77_idx.size:
        do_av = do_av.copy()
        do_av[e77_idx] = True

    # --- slice into chunks ----------------------------------------------
    def make(i0, i1, event, emit_local=()):
        sl = slice(i0, i1)
        xs = dict(cos_t=cos_t[sl], cos_t_dt=cos_t_dt[sl], cos_hs=cos_hs[sl],
                  cos_hs_dt=cos_hs_dt[sl], cos_av=cos_av[sl],
                  sin_av=sin_av[sl], do_av=do_av[sl], t=ts[sl])
        return Chunk(xs=xs, n_steps=i1 - i0, event=event,
                     t_first=float(ts[i0]), t_last=float(ts[i1 - 1]),
                     emit_idx=tuple(emit_local))

    if break_on_e77 and e77_idx.size:
        cuts = e77_idx
        batched77 = np.empty(0, np.int64)
    else:
        cuts = np.concatenate([e7_idx, e9_idx]).astype(np.int64)
        cuts.sort()
        batched77 = e77_idx

    start = 0
    for e in cuts.tolist():
        if display == 77:
            # pre-step state must be observable: the emitting step is its
            # own 1-step chunk, preceded by a plain flush
            for j in range(start, e, chunk_max):
                yield make(j, min(j + chunk_max, e), None)
            yield make(e, e + 1, "e77")
            start = e + 1
        else:
            # the emitting step ENDS its chunk (it is included)
            event = "e7" if display == 7 else "e9"
            for j in range(start, e + 1, chunk_max):
                hi = min(j + chunk_max, e + 1)
                yield make(j, hi, event if hi == e + 1 else None)
            start = e + 1
    bi = 0
    for j in range(start, n, chunk_max):
        hi = min(j + chunk_max, n)
        lo_b = bi
        while bi < batched77.size and batched77[bi] < hi:
            bi += 1
        yield make(j, hi, None, emit_local=(batched77[lo_b:bi] - j).tolist())

    if carry_out is not None:
        carry_out["frame_time"] = ft_final
        carry_out["last_rem"] = last_rem_final
        carry_out["t_exit"] = float(ts[n])


def iter_chunks_sequential(*, omega, dt, t0, t_max, t_start, E_omega,
                           display, frame_start, T, dtype=f32,
                           chunk_max=4096, frame_time0=0.0,
                           last_tT_reminder0=0.0, av_always_off=False,
                           carry_out: Optional[dict] = None,
                           break_on_e77: bool = True) -> Iterator[Chunk]:
    """Step-by-step scalar emulation of the C time loop — the readable
    specification of iter_chunks' semantics, cross-checked against it in
    tests.  Not used by the driver (O(10 us) host work per step).
    """
    D = dtype
    omega = D(omega)
    dt = D(dt)
    t = D(t0)
    t_max = D(t_max)
    t_start = D(t_start)
    T = D(T)
    frame_time = D(frame_time0)
    last_rem = D(last_tT_reminder0)
    e_om_pos = float(E_omega) > 0

    buf: list[tuple] = []   # (t, cos_t, cos_t_dt, cos_hs, cos_hs_dt, cos_av, sin_av, do_av)
    emit_idx: list[int] = []

    def trig(x):
        # C: cos(omega*t) — float product, double cos, float store
        return D(np.cos(f64(D(omega * x))))

    def strig(x):
        return D(np.sin(f64(D(omega * x))))

    def flush(event=None, t_last=None):
        nonlocal buf, emit_idx
        if not buf and event is None:
            return None
        cols = list(zip(*buf)) if buf else [[]] * 8
        xs = dict(
            cos_t=np.asarray(cols[1], D), cos_t_dt=np.asarray(cols[2], D),
            cos_hs=np.asarray(cols[3], D), cos_hs_dt=np.asarray(cols[4], D),
            cos_av=np.asarray(cols[5], D), sin_av=np.asarray(cols[6], D),
            do_av=np.asarray(cols[7], bool),
            t=np.asarray(cols[0], D),
        )
        ch = Chunk(xs=xs, n_steps=len(buf), event=event,
                   t_first=float(cols[0][0]) if buf else float(t),
                   t_last=float(t_last if t_last is not None
                                else (cols[0][-1] if buf else t)),
                   emit_idx=tuple(emit_idx))
        buf = []
        emit_idx = []
        return ch

    while t < t_max:
        t_hs = D(t + dt / 2)
        cos_t = trig(t)
        cos_t_dt = trig(D(t + dt))
        cos_hs = trig(t_hs)
        cos_hs_dt = trig(D(t_hs + dt))

        emit77 = (e_om_pos and display == 77 and frame_time >= 0.01)
        do_av = emit77 or (
            e_om_pos and display not in (7, 77, 8) and t >= t_start
            and not av_always_off)
        step_rec = (t, cos_t, cos_t_dt, cos_hs, cos_hs_dt,
                    trig(t), strig(t), bool(do_av))

        if emit77 and break_on_e77:
            # pre-step state must be observable: cut before, 1-step chunk
            ch = flush()
            if ch:
                yield ch
            buf.append(step_rec)
            yield flush(event="e77", t_last=t)
            frame_time = D(0)
        else:
            buf.append(step_rec)
            if emit77:
                # batched mode: the scan collects the emission record
                # on-device; remember which row it lands in
                emit_idx.append(len(buf) - 1)
                frame_time = D(0)

        emit7 = (display == 7 and frame_time >= 0.01 and t > frame_start)
        emit9 = False
        if display == 9 and t >= t_start and float(T) > 0:
            tT = D(t / T)
            rem = D(tT - int(tT))
            if rem < last_rem:
                emit9 = True
            last_rem = rem
        if emit7:
            yield flush(event="e7", t_last=t)
            frame_time = D(0)
        elif emit9:
            yield flush(event="e9", t_last=t)

        frame_time = D(frame_time + dt)
        t = D(t + dt)
        if len(buf) >= chunk_max:
            ch = flush()
            if ch:
                yield ch

    ch = flush()
    if ch:
        yield ch
    if carry_out is not None:
        carry_out["frame_time"] = float(frame_time)
        carry_out["last_rem"] = float(last_rem)
        carry_out["t_exit"] = float(t)   # first t failing t < t_max
