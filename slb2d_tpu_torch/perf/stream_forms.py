"""B2's forms on the card: the measurements behind the spill form's L2
budget (ops/stepper_stream_cuda.py SPILL_L2_BUDGET), the tiling form's
width (default_geometry) and impl=cuda's routing (engine_choice).

    python -m slb2d_tpu_torch.perf.stream_forms [experiment ...]

runs the named experiments (all of them by default) and prints one line
per experiment and one JSON line.  Every engine is timed per step with
CUDA events over 2000 steps in one chunk after a warm-up, BASELINE #4's
physics, and the engines of one shape in turns (a, b, ..., b, a).  It
needs a card (main() refuses the CPU).

  limit    the spill form, its budget lifted, against the tiling form at
           N=100 f32 over M=20000-32000: where the spill form stops
           winning
  columns  B1's per-half-step form per column at N=100 f32, M=16000,
           20000 and 24000 (a working set of ~40, ~50 and ~60 MB, across
           the 50 MB L2)
  waves    the tiling form at default_geometry's W (the fewest waves x
           WT) against the widest W that fits in shared memory, at N=100
           M=20000 and at N=400 M=4000, f32
  f64      the spill form against B1's per-half-step form in f64 at
           N=100 M=9000, 12000 and 14750 (the f64 plan's lower and upper
           edge and its middle)
  nhp      f32 past B1's resident plan at another height than N=100:
           N=400 M=6000 and M=7000 (NHP=408, R=32) and N=200 M=12000
           (NHP=208, R=64), the spill form against the tiling form and
           B1's per-half-step form
"""

from __future__ import annotations

import json
import sys

from . import have_card, time_ms

# BASELINE #4's physics (bench.PHYS with its omega)
PHYS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
            phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3)
STEPS = 2000

LIMIT_M = (20000, 24000, 28000, 30000, 31000, 32000)
COLUMNS_M = (16000, 20000, 24000)
WAVES = ((100, 20000), (400, 4000))
F64_M = (9000, 12000, 14750)
NHP_SHAPES = ((400, 6000), (400, 7000), (200, 12000))
EXPERIMENTS = ("limit", "columns", "waves", "f64", "nhp")


def setup(N, M, dtype="f32", device="cuda:0"):
    """(model, consts, xs) of a display-4 run at N, M: the table's first
    chunk, 2500 steps from t=0 (the averaging window opens at t=0.05)."""
    import torch
    from ..config import SimConfig
    from ..models.superlattice import SuperlatticeModel
    from ..ops import stencil
    from ..runtime import schedule
    cfg = SimConfig(display=4, t_start=0.05, dtype=dtype, n_harmonics=N,
                    g_grid=M, **PHYS)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, torch.device(device))
    chunk = next(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=2.5,
        t_start=cfg.t_start, E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=10**9))
    return model, c, chunk.xs


def make_runner(N, M, engine, form, dtype="f32", device="cuda:0",
                budget=None, W=None):
    """(model, consts, xs, runner): engine "cuda-b1" (make_cuda_runner in
    `form`) or "stream" (make_stream_runner in `form`; `budget` lifts or
    sets the spill plan's L2 budget, W the tiling form's width)."""
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    model, c, xs = setup(N, M, dtype, device)
    if engine == "cuda-b1":
        return model, c, xs, stepper_cuda.make_cuda_runner(c, model,
                                                           form=form)
    spill = None
    if budget is not None:
        spill = sst.spill_plan(model.NHP, model.MP, model.np_dtype,
                               stepper_cuda.card_sms(device), budget=budget)
    runner = sst.make_stream_runner(c, model, form=form, spill=spill, W=W)
    return model, c, xs, runner


def engine_ms(N, M, engine, form, dtype="f32", device="cuda:0", n=STEPS,
              reps=3, **kw):
    """ms per step of one engine and form (make_runner's kw) at N, M: n
    steps in one chunk, after a warm-up chunk."""
    from ..ops import stencil
    model, c, xs, runner = make_runner(N, M, engine, form, dtype, device,
                                       **kw)
    if runner.form != form:
        raise RuntimeError(f"{engine} at N={N} M={M}: the {runner.form} "
                           f"form, not {form}")
    win = {k: v[:n] for k, v in xs.items()}
    st = stencil.bootstrap_state(c, model)
    return time_ms(lambda: runner.run_xs(st, win, 0), device, reps) / n


def in_turns(fns, device="cuda:0", reps=2):
    """{name: [ms per step, ms per step]} of fns[name] = (args, kw) of
    engine_ms, run in turns: each name, then each in reverse."""
    t = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        args, kw = fns[k]
        t[k].append(engine_ms(*args, device=device, reps=reps, **kw))
    return t


def fmt(t):
    return ", ".join(f"{k} " + "/".join(f"{v * 1e3:.3f}" for v in vs)
                     for k, vs in t.items())


def model_of(N, M, dtype="f32"):
    from ..config import SimConfig
    from ..models.superlattice import SuperlatticeModel
    return SuperlatticeModel(SimConfig(display=4, t_start=0.05, dtype=dtype,
                                       n_harmonics=N, g_grid=M, **PHYS))


def limit(device):
    """Spill (budget lifted) against tiling at N=100 f32 over LIMIT_M."""
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    sms = stepper_cuda.card_sms(device)
    out = {}
    for M in LIMIT_M:
        m = model_of(100, M)
        p = sst.spill_plan(m.NHP, m.MP, m.np_dtype, sms, budget=2**62)
        t = in_turns({"spill": ((100, M, "stream", "spill"),
                                dict(budget=2**62)),
                      "tiling": ((100, M, "stream", "tiling"), {})}, device)
        out[M] = dict(us=t, S=p.S, l2_bytes=p.spill_bytes
                      + m.NHP * m.MP * 4, planned=sst.spill_plan(
                          m.NHP, m.MP, m.np_dtype, sms) is not None)
    line = "; ".join(
        f"M={M} (S={v['S']}, slabs + a0 {v['l2_bytes']} B, "
        f"{'planned' if v['planned'] else 'past the budget'}) "
        f"{fmt(v['us'])} us" for M, v in out.items())
    return out, f"spill limit, N=100 f32, spill against tiling: {line}"


def columns(device):
    """B1's per-half-step form per column at N=100 f32 over COLUMNS_M."""
    out = {}
    for M in COLUMNS_M:
        m = model_of(100, M)
        ms = [engine_ms(100, M, "cuda-b1", "per-half-step", device=device,
                        reps=2) for _ in range(2)]
        out[M] = dict(ns_per_column=[v * 1e6 / m.MP for v in ms],
                      working_set_bytes=6 * m.NHP * m.MP * 4)
    line = "; ".join(f"M={M} (working set {v['working_set_bytes']} B) "
                     + "/".join(f"{x:.4f}" for x in v["ns_per_column"])
                     + " ns" for M, v in out.items())
    return out, f"B1 per-half-step per column, N=100 f32: {line}"


def waves(device):
    """The tiling form at default_geometry's W against the widest that
    fits, at each of WAVES."""
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    sms = stepper_cuda.card_sms(device)
    out, parts = {}, []
    for N, M in WAVES:
        m = model_of(N, M)
        g = sst.default_geometry(m.NHP, m.MP, 4, sms=sms)
        w_fit = max(w for w in range(1, 1000) if sst.default_geometry(
            m.NHP, m.MP, 4, W=w).smem)
        t = in_turns({f"W={w}": ((N, M, "stream", "tiling"), dict(W=w))
                      for w in (g.W, w_fit)}, device)
        out[f"N={N} M={M}"] = dict(
            us=t, chosen=g.W, widest=w_fit,
            tiles={g.W: -(-m.MP // g.W), w_fit: -(-m.MP // w_fit)})
        parts.append(f"N={N} M={M} ({-(-m.MP // g.W)} and "
                     f"{-(-m.MP // w_fit)} tiles on {sms} SMs) {fmt(t)} us")
    return out, "tiling W by waves against the widest: " + "; ".join(parts)


def f64(device):
    """The spill form against B1's per-half-step form in f64 at N=100
    over F64_M."""
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    sms = stepper_cuda.card_sms(device)
    out, parts = {}, []
    for M in F64_M:
        m = model_of(100, M, "f64")
        p = sst.spill_plan(m.NHP, m.MP, m.np_dtype, sms)
        t = in_turns({"spill": ((100, M, "stream", "spill", "f64"), {}),
                      "per-half-step": ((100, M, "cuda-b1", "per-half-step",
                                         "f64"), {})}, device)
        out[M] = dict(us=t, R=p.R, S=p.S,
                      choice=list(sst.engine_choice(m.NHP, m.MP,
                                                    m.np_dtype, sms)))
        parts.append(f"M={M} (R={p.R}, S={p.S}) {fmt(t)} us")
    return out, "f64 N=100, spill against per-half-step: " + "; ".join(parts)


def nhp(device):
    """f32 past B1's resident plan at NHP_SHAPES: spill, tiling and
    per-half-step."""
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    sms = stepper_cuda.card_sms(device)
    out, parts = {}, []
    for N, M in NHP_SHAPES:
        m = model_of(N, M)
        p = sst.spill_plan(m.NHP, m.MP, m.np_dtype, sms)
        g = sst.default_geometry(m.NHP, m.MP, 4, sms=sms)
        t = in_turns({"spill": ((N, M, "stream", "spill"), {}),
                      "tiling": ((N, M, "stream", "tiling"), {}),
                      "per-half-step": ((N, M, "cuda-b1", "per-half-step"),
                                        {})}, device)
        out[f"N={N} M={M}"] = dict(us=t, R=p.R, S=p.S, tiling_W=g.W,
                                   choice=list(sst.engine_choice(
                                       m.NHP, m.MP, m.np_dtype, sms)))
        parts.append(f"N={N} M={M} (NHP={m.NHP}, R={p.R}, S={p.S}; tiling "
                     f"W={g.W}) {fmt(t)} us")
    return out, "f32 past the resident plan: " + "; ".join(parts)


RUNS = {"limit": limit, "columns": columns, "waves": waves, "f64": f64,
        "nhp": nhp}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    names = argv or list(EXPERIMENTS)
    bad = [a for a in names if a not in RUNS]
    if bad:
        print(f"ERROR: no experiment {', '.join(bad)} (experiments: "
              f"{', '.join(EXPERIMENTS)})", file=sys.stderr)
        return 2
    if not have_card():
        return 1
    from ..bench import device_line
    card = device_line()
    res = {}
    for name in names:
        res[name], line = RUNS[name]("cuda:0")
        print(f"{line} [{card}]", flush=True)
    print(json.dumps({"experiment": "B2 forms", "device": card,
                      "steps": STEPS, **{k: {str(kk): vv for kk, vv in
                                             v.items()}
                                         for k, v in res.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
