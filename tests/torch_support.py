"""What the port's tests share: one torch thread, and the checks on a card.

Importing this module pins torch to one intra-op thread.  The tier-1 suite
runs six xdist workers; with torch's default pool each of them runs a
thread per core, and the port's CPU runs (tensors of a few thousand
elements, which intra-op threads do not speed up) spend their time with
those threads spinning against the other workers'.  Every test_torch_*
module imports it.

The rest is what tests/test_torch_cuda.py runs on a card: the shapes and
tolerances, the set-ups, each kernel against its plain version, the
CLIs' and Simulation's runs with their launch counts, the goldens.  Like
that file it imports neither jax nor the JAX package, so it loads
without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import os
import tempfile

import numpy as np
import torch

torch.set_num_threads(1)

from slb2d_tpu_torch import tracing  # noqa: E402
from slb2d_tpu_torch.config import SimConfig  # noqa: E402
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel  # noqa: E402
from slb2d_tpu_torch.ops import stencil, stepper_cuda  # noqa: E402
from slb2d_tpu_torch.ops import stepper_stream_cuda as sst  # noqa: E402
from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc  # noqa: E402
from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc  # noqa: E402
from slb2d_tpu_torch.runtime import schedule  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda:0"

# BASELINE #4 (BASELINE.md): the flagship display-4 run
PHYS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
            phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3)
BASELINE4 = dict(n_harmonics=100, g_grid=4000)
SMALL = dict(n_harmonics=8, g_grid=64)
MAIN_ARGV = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1.0",
             "alpha=0.9495", "n-harmonics=100", "PhiYmin=-10",
             "PhiYmax=10", "B=0.1", "t-max=10", "dt=1e-3", "g-grid=4000",
             "dtype=f32", "impl=cuda", "quiet=1"]
# the stream engine's shapes: the wide grid N=100 M=12000 (NHP=104,
# MP=12032) and the tall-thin N=400 M=4000 (NHP=408, MP=4096)
WIDE = dict(n_harmonics=100, g_grid=12000)
TALL = dict(n_harmonics=400, g_grid=4000)
# the first f32 shape past B1's resident plan (N=100 M=16000 still has
# one): impl=cuda runs B2's spill form there
B2_OWN = dict(n_harmonics=100, g_grid=20000)
# BASELINE.md #1 (display 8, N=20 M=200) and #3's grid (display 7, N=20
# M=1000; the bench's movie: t-max=0.3, omega=10)
BASELINE1 = dict(n_harmonics=20, g_grid=200)
BASELINE3 = dict(n_harmonics=20, g_grid=1000)
MOVIE = dict(t_start=0.3, **{**PHYS, "omega": 10.0})

# kernel vs plain: f64 is held to rounding differences (reciprocal vs
# division, reduction order); f32 to tests/test_pallas.py's
# interpreter-vs-scan envelope (the same differences at float32)
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=1e-4, atol=1e-7)}
# the D7 envelope of a float32 frame (tests/test_golden.py)
FRAME_TOL = dict(rtol=2e-4, atol=3e-6)
# sweep observables compared between engines, and their tolerance
OBS = ("v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin", "v_dr_inst",
       "v_y_inst", "m_over_m_x_inst", "norm", "av_count")
OBS_TOL = dict(rtol=2e-4, atol=2e-5)
STATE = ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b")

# B2's spill form at small shapes through forced plans (few bands, narrow
# resident parts, so that every band spills): (name, shape, dtype, bands,
# R).  N=13 M=300 (NHP=16, MP=384): 5 bands of 76-77 columns, 12-13 of
# them spilled, column M+1 = 301 in band 3's slab
SPILL_FORCED = (("N=8 M=64", SMALL, "f32", 2, 32),
                ("N=8 M=64", SMALL, "f64", 2, 32),
                ("N=13 M=300", dict(n_harmonics=13, g_grid=300), "f32", 5,
                 64),
                ("N=13 M=300", dict(n_harmonics=13, g_grid=300), "f64", 5,
                 64))

# the sweeps' shapes (sweep_grid): the 64-point E_dc sweep of the bench
# (BASELINE #2's N=40 M=500, one drive period a point); tests/
# test_sweep_stack.py's ragged grid (6 points, point 2 dc-only, mu swept)
# and ragged omega grid (5 points, point 2 dc-only) cut to t-max 0.01, so
# a run of the whole sweep crosses every point's loop exit
SWEEP_FULL = dict(n_harmonics=40, g_grid=500, t_start=0.1)
SWEEP_POINTS = 64
SWEEP_ARGV = ["E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1.0",
              "alpha=0.9495", "n-harmonics=40", "PhiYmin=-10", "PhiYmax=10",
              "B=0.1", "t-max=0.1", "dt=1e-3", "g-grid=500", "dtype=f32",
              "impl=cuda", "quiet=1", "sweep:E_dc=0.1,3.0,64"]
SWEEP_RAGGED = dict(n_harmonics=8, g_grid=24, t_start=0.2, omega=10.0)
RAGGED_PARAMS = {"E_omega": [2.0, 2.0, 0.0, 1.5, 2.0, 2.0],
                 "mu": [1.0, 1.2, 1.0, 0.8, 1.0, 1.1]}
OMEGA_RAGGED = dict(n_harmonics=8, g_grid=24, t_start=0.01, omega=10.0)
OMEGA_RAGGED_PARAMS = {"omega": [8.0, 10.0, 12.0, 14.0, 10.0],
                       "E_dc": [0.4, 0.75, 1.1, 1.45, 1.8],
                       "E_omega": [2.0, 2.0, 0.0, 1.5, 2.0]}
# the absorption map's points (examples/absorption_map.py paper): 16
# omegas x 4 E_dc at one drive period, and the 16 x 16 paper map itself
MAP = dict(E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0, alpha=0.9495,
           phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3, n_harmonics=40,
           g_grid=500)
PAPER_ARGV = ["E_dc=0.0", "E_omega=1.5", "omega=1.0", "mu=1.0",
              "alpha=0.9495", "n-harmonics=40", "PhiYmin=-10", "PhiYmax=10",
              "B=0.1", "t-max=5", "dt=1e-3", "g-grid=500", "dtype=f32",
              "impl=cuda", "quiet=1", "sweep:E_dc=0,3,16",
              "sweep:omega=6,14,16"]
# tests/test_sweep_pallas.py's grid: 3 points (point 2 dc-only) at N=6
# M=29, omega=20, t-max=0.02 (335 steps)
LANES3 = dict(E_dc=1.0, E_omega=2.0, omega=20.0, mu=1.0, alpha=0.9495,
              n_harmonics=6, phi_y_min=-5.0, phi_y_max=5.0, B=0.1,
              t_start=0.02, g_grid=29, dt=1e-3)
LANES3_PARAMS = {"E_dc": [0.5, 1.25, 2.0], "E_omega": [2.0, 2.0, 0.0]}
# sweeps past cluster residency, on B3's streaming form: 8 points at
# BASELINE #4's N=100 M=4000, E_dc swept, and 8 omegas (t-max=0.01, so a
# run to the end, 321 steps, crosses every loop exit); the ragged grids'
# points at N=40 M=500, where 2 (float) or 4 (double) blocks are the
# smallest cluster to hold a point
WIDE8 = dict(t_start=0.1, **BASELINE4)
OMEGA_WIDE8 = dict(t_start=0.01, **BASELINE4)
GRID40 = dict(n_harmonics=40, g_grid=500)


def allclose(got, ref, rtol, atol, what):
    """max |got - ref| of two tensors, arrays or numbers of one shape,
    failing where it passes atol + rtol * |ref| (or either is NaN)."""
    got, ref = (x.detach().double().cpu() if torch.is_tensor(x)
                else torch.as_tensor(np.asarray(x, float))
                for x in (got, ref))
    assert got.shape == ref.shape, f"{what}: {got.shape} vs {ref.shape}"
    if not got.numel():
        return 0.0
    err = (got - ref).abs()
    bad = ~(err <= atol + rtol * ref.abs())
    assert not bool(torch.isnan(got).any()), f"{what}: NaN"
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} entries outside rtol={rtol} atol={atol}, "
        f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def same_state(x, y, what, fields=STATE):
    for f in fields:
        k, p = getattr(x, f), getattr(y, f)
        assert torch.equal(k, p), (
            f"{what}: {f} not bit for bit, max abs err "
            f"{float((k.double() - p.double()).abs().max()):.3e}")


def _state_equal(x, y, what, dtype="f32"):
    """State, edges, t and step bit for bit; returns av's max abs error
    (at TOL)."""
    same_state(x, y, what, STATE + ("t", "step"))
    return allclose(x.av, y.av, what=f"{what} av", **TOL[dtype])


def _setup(shape, dtype, device=DEVICE):
    """(model, consts, xs) of a display-4 run at BASELINE #4's physics:
    the table's first chunk, 2500 steps from t=0 (averaging from 0.05)."""
    cfg = SimConfig(display=4, t_start=0.05, dtype=dtype, **PHYS, **shape)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, torch.device(device))
    chunks = list(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=2.5,
        t_start=cfg.t_start, E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=10**9))
    return model, c, chunks[0].xs


def _two_chunks(xs, n_steps):
    """The first n_steps rows in two chunks, the first odd (the second
    starts at parity 1), with the display-77 records each emits."""
    n1 = n_steps // 2 + 1
    n2 = n_steps - n1
    return [({k: v[:n1] for k, v in xs.items()}, (0, 3, n1 // 2, n1 - 1)),
            ({k: v[n1:n_steps] for k, v in xs.items()},
             (1, n2 // 2, n2 - 1))]


def _vs_b1_plain(runner, model, c, xs, n_steps, what, launches):
    """runner (B1, or B2's spill form) and B1's plain version from one
    state over _two_chunks with display-77 records: state and edges bit
    for bit, av and records at TOL, launches(n, records) a chunk, and av
    nonzero where the table opened the averaging window.  Returns the
    largest abs difference."""
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = state0.clone(), state0.clone()
    tol = TOL["f64" if model.np_dtype == np.float64 else "f32"]
    err, steps = 0.0, 0
    for xs_part, emit in _two_chunks(xs, n_steps):
        launches0 = runner.launches
        kern = runner.run_xs(kern, xs_part, steps % 2, emit_idx=emit)
        plain, plain_obs = stepper_cuda.run_chunk_plain(
            c, plain, stepper_cuda.pack_xs_dict(xs_part, model.np_dtype),
            steps % 2, emit)
        torch.cuda.synchronize()
        n = len(xs_part["t"])
        steps += n
        got = runner.launches - launches0
        assert got == launches(n, len(emit)), f"{what}: {got} launches"
        same_state(kern, plain, what)
        err = max(err, allclose(kern.av, plain.av, what=f"{what} av", **tol))
        assert int(kern.step) == int(plain.step) == steps, what
        assert float(kern.t) == float(plain.t), f"{what}: loop t"
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        assert torch.equal(obs[:, 4], ref[:, 4]), f"{what}: record loop t"
        err = max(err, allclose(obs, ref, what=f"{what} d77 records", **tol))
    if xs["do_av"][:n_steps].any():
        assert bool(kern.av[0] > 0), f"{what}: av never fired"
    return err


def check_kernel_vs_plain(shape, dtype, n_steps=500, form=None):
    """B1 (in `form`, as make_cuda_runner takes it: None is
    resident_plan's) against its plain version over the same exact table.
    Returns (the largest abs difference of av and the records, the
    runner)."""
    model, c, xs = _setup(shape, dtype)
    runner = stepper_cuda.make_cuda_runner(c, model, form=form)

    def launches(n, records):
        if runner.form == "resident":
            return stepper_cuda.LAUNCHES_PER_CHUNK
        return stepper_cuda.LAUNCHES_PER_STEP * n + records
    err = _vs_b1_plain(runner, model, c, xs, n_steps,
                       f"B1 {runner.form} {dtype} {shape}", launches)
    return err, runner


def _forms_agree(runners, model, c, xs, dtype, what, n_steps=203):
    """Every runner of {name: runner} from one state over the same n_steps
    with display-77 records: state and edges bit for bit with the first,
    av and records at TOL (the sums' order).  Returns {name: state}."""
    part = {k: v[:n_steps] for k, v in xs.items()}
    emit = (0, 57, 130, n_steps - 1)
    state0 = stencil.bootstrap_state(c, model)
    out = {k: r.run_xs(state0.clone(), part, 0, emit_idx=emit)
           for k, r in runners.items()}
    torch.cuda.synchronize()
    (first, ref), *others = out.items()
    obs = {k: torch.from_numpy(r.take_obs(len(emit)))
           for k, r in runners.items()}
    assert bool(ref.av[0] > 0), f"{what}: av never fired"
    for k, st in others:
        same_state(st, ref, f"{what}: {k} vs {first}")
        allclose(st.av, ref.av, what=f"{what}: {k} av", **TOL[dtype])
        allclose(obs[k], obs[first], what=f"{what}: {k} d77 records",
                 **TOL[dtype])
    return out


def check_resident_vs_per_half_step(shape, dtype="f32", n_steps=203):
    """B1's two forms over n_steps with display-77 records; one launch on
    the resident form."""
    model, c, xs = _setup(shape, dtype)
    res = stepper_cuda.make_cuda_runner(c, model, form="resident")
    per = stepper_cuda.make_cuda_runner(c, model, form="per-half-step")
    _forms_agree({"resident": res, "per-half-step": per}, model, c, xs,
                 dtype, f"B1 forms {dtype} {shape}", n_steps)
    assert res.launches == stepper_cuda.LAUNCHES_PER_CHUNK


def _stream_runner(shape, dtype, forced=None, **kw):
    """(model, consts, xs, B2 runner) at one shape; kw go to
    make_stream_runner (form, K, W).  forced = (bands, R): a forced spill
    plan."""
    model, c, xs = _setup(shape, dtype)
    if forced is not None:
        kw["spill"] = sst.spill_plan(model.NHP, model.MP, model.np_dtype,
                                     sms=forced[0], R=forced[1])
        assert kw["spill"] is not None, f"no spill plan {forced} at {shape}"
    return model, c, xs, sst.make_stream_runner(c, model, **kw)


def _stream_parts(xs, K):
    """Rows from step 45 (across the averaging window's start at step
    50): K+3 steps (a full launch and a partial one), then 5 from parity
    1, with display-77 records."""
    rows = {k: v[45:45 + K + 8] for k, v in xs.items()}
    return [({k: v[:K + 3] for k, v in rows.items()}, (0, 4, K + 2)),
            ({k: v[K + 3:] for k, v in rows.items()}, (0, 2, 4))]


def _vs_stream_plain(model, c, xs, runner, plain_chunk, per_launch, what,
                     dtype, scatter=lambda st: st.clone(),
                     gather=lambda st: st):
    """runner (B2's tiling or sharded form) against its plain version
    plain_chunk(c, state, table, parity0, emit, geom) over _stream_parts:
    state and edges bit for bit; av and records at TOL (the block sums'
    order); per_launch launches a round of K steps.  Returns the largest
    abs difference of av and the records."""
    K = runner.geom.K
    state0 = stencil.bootstrap_state(c, model)
    kern, plain = scatter(state0), scatter(state0)
    err, steps = 0.0, 0
    for xs_part, emit in _stream_parts(xs, K):
        n = len(xs_part["t"])
        launches0 = runner.launches
        kern = runner.run_xs(kern, xs_part, steps % 2, emit_idx=emit)
        plain, plain_obs = plain_chunk(
            c, plain, stepper_cuda.pack_xs_dict(xs_part, model.np_dtype),
            steps % 2, emit, runner.geom)
        torch.cuda.synchronize()
        steps += n
        assert runner.launches - launches0 == per_launch * -(-n // K), what
        k_st, p_st = gather(kern), gather(plain)
        same_state(k_st, p_st, what)
        assert bool(k_st.av[0] > 0), f"{what}: av never fired"
        err = max(err, allclose(k_st.av, p_st.av, what=f"{what} av",
                                **TOL[dtype]))
        assert int(k_st.step) == int(p_st.step) == steps, what
        obs = torch.from_numpy(runner.take_obs(len(emit)))
        ref = plain_obs[:, :13].cpu()
        assert torch.equal(obs[:, 4], ref[:, 4]), f"{what}: record loop t"
        err = max(err, allclose(obs, ref, what=f"{what} d77 records",
                                **TOL[dtype]))
    return err


def check_stream_vs_plain(shape, dtype):
    """B2's tiling form against its plain version (_vs_stream_plain)."""
    model, c, xs, runner = _stream_runner(shape, dtype)
    return _vs_stream_plain(model, c, xs, runner, sst.run_chunk_plain_stream,
                            sst.LAUNCHES_PER_LAUNCH,
                            f"stream {dtype} {shape} {tuple(runner.geom)}",
                            dtype)


def check_stream_vs_b1(shape, dtype="f32", n_steps=203):
    """B2 and B1 from one state over n_steps (odd: full launches and a
    partial one) with display-77 records."""
    model, c, xs, runner = _stream_runner(shape, dtype)
    _forms_agree({"B2": runner,
                  "B1": stepper_cuda.make_cuda_runner(c, model)},
                 model, c, xs, dtype, f"stream vs B1 {dtype} {shape}",
                 n_steps)


def check_spill_vs_plain(shape, dtype, n_steps=200, forced=None):
    """B2's spill form (its plan, or forced = (bands, R)) against its
    plain version, B1's run_chunk_plain, one launch a chunk.  Returns (the
    largest abs difference of av and the records, the runner)."""
    model, c, xs, runner = _stream_runner(shape, dtype, forced=forced,
                                          form="spill")
    p = runner.plan
    err = _vs_b1_plain(runner, model, c, xs, n_steps,
                       f"B2 spill {dtype} {shape} ({p.bands} bands, "
                       f"R={p.R}, S={p.S})", lambda n, records: 1)
    return err, runner


def check_stream_forms(shape, dtype="f32", n_steps=203):
    """B2's spill and tiling forms and B1's per-half-step form over
    n_steps with display-77 records."""
    model, c, xs, spill = _stream_runner(shape, dtype, form="spill")
    _forms_agree({"spill": spill,
                  "tiling": sst.make_stream_runner(c, model, form="tiling"),
                  "per-half-step": stepper_cuda.make_cuda_runner(
                      c, model, form="per-half-step")},
                 model, c, xs, dtype, f"B2 forms {dtype} {shape}", n_steps)


@contextlib.contextmanager
def forced_spill(bands):
    """Within it, B2's runners take a spill plan of `bands` bands at any
    shape, with the widest R that leaves each band two spill columns: the
    spill form at the goldens' small shapes."""
    plan = sst.spill_plan

    def forced(NHP, MP, dtype, sms=None, **kw):
        return plan(NHP, MP, dtype, sms=bands,
                    R=min((MP // bands - 2) // 32 * 32, 512))
    sst.spill_plan = forced
    try:
        yield
    finally:
        sst.spill_plan = plan


@contextlib.contextmanager
def forced_form(form, bands=2):
    """Within it, a Simulation's kernel engine takes `form`:
    None (the plans' choice), "per-half-step" (impl=cuda: B1 without a
    resident plan), "tiling" (impl=stream: B2 without a spill plan) or
    "spill" (impl=stream: forced_spill(bands) at any shape)."""
    saved = (stepper_cuda.resident_plan, sst.spill_plan, sst.stream_beats_b1)
    try:
        if form == "spill":
            with forced_spill(bands):
                yield
            return
        if form == "per-half-step":
            stepper_cuda.resident_plan = lambda *a, **k: None
            sst.stream_beats_b1 = lambda *a, **k: False
        elif form == "tiling":
            sst.spill_plan = lambda *a, **k: None
        yield
    finally:
        (stepper_cuda.resident_plan, sst.spill_plan,
         sst.stream_beats_b1) = saved


def sweep_grid(shape):
    """(config keywords, params) of one sweep check shape."""
    if shape == "ragged":
        params = {"E_dc": np.linspace(0.3, 2.0, 6),
                  **{k: np.asarray(v) for k, v in RAGGED_PARAMS.items()}}
        return {**PHYS, **SWEEP_RAGGED}, params
    if shape in ("ragged40", "omega_ragged40"):
        kw, params = sweep_grid(shape[:-2])
        return {**kw, **GRID40}, params
    if shape == "omega_ragged":
        return ({**PHYS, **OMEGA_RAGGED},
                {k: np.asarray(v) for k, v in OMEGA_RAGGED_PARAMS.items()})
    if shape in ("omega16x4", "paper"):
        e_dc = np.linspace(0.0, 3.0, 4 if shape == "omega16x4" else 16)
        E, W = np.meshgrid(e_dc, np.linspace(6.0, 14.0, 16), indexing="ij")
        return ({**MAP, "t_start": 0.05 if shape == "omega16x4" else 5.0},
                {"E_dc": E.ravel(), "omega": W.ravel()})
    if shape == "lanes3":
        return LANES3, {k: np.asarray(v) for k, v in LANES3_PARAMS.items()}
    if shape == "wide8":
        return {**PHYS, **WIDE8}, {"E_dc": np.linspace(0.5, 2.0, 8)}
    if shape == "omega_wide8":
        return ({**PHYS, **OMEGA_WIDE8},
                {"omega": np.linspace(20.0, 30.0, 8)})
    return ({**PHYS, **SWEEP_FULL},
            {"E_dc": np.linspace(0.1, 3.0, SWEEP_POINTS)})


def _sweep_setup(shape, dtype, impl="cuda", cluster_size=None):
    """(sweep, its B3 runner) at one sweep check shape; cluster_size as
    SweepStackRunner takes it (None: cluster_plan's form, 0: the
    streaming form)."""
    from slb2d_tpu_torch.parallel.sweep import ParameterSweep
    kw, params = sweep_grid(shape)
    cfg = SimConfig(display=4, dtype=dtype, impl=impl, quiet=True, **kw)
    sweep = ParameterSweep(cfg, params, device=torch.device(DEVICE))
    if impl == "torch":
        return sweep, None
    assert sweep.engine == "cuda", f"sweep engine {sweep.engine}"
    return sweep, ssc.SweepStackRunner(sweep, cluster_size=cluster_size)


def _zero_cap(sweep, frames=False):
    """A fresh loop-exit capture dict of a sweep, with the frames arrays
    "a", "b" when `frames`."""
    dt, dev = sweep.consts.a0.dtype, sweep.device
    cap = {k: torch.zeros(sweep.B, dtype=dt, device=dev)
           for k in stencil.CAP_KEYS}
    if frames:
        shape = (sweep.B, sweep.base.NHP, sweep.base.MP)
        cap["a"] = torch.zeros(shape, dtype=dt, device=dev)
        cap["b"] = torch.zeros(shape, dtype=dt, device=dev)
    return cap


def _b3_chunk_launches(n):
    return -(-n // ssc.CHUNK_STEPS) * ssc.LAUNCHES_PER_CHUNK


def _sweep_chunk_checks(runner, kern, plain, launches0, n, what, tol):
    assert runner.launches - launches0 == _b3_chunk_launches(n), what
    same_state(kern, plain, what)
    dc_only = ~runner.egate
    for st in (kern, plain):
        assert bool(torch.all(st.av[dc_only] == 0)), \
            f"{what}: the dc-only point's av is not 0"
    assert torch.equal(kern.step, plain.step), f"{what}: step count"
    assert torch.equal(kern.t, plain.t), f"{what}: loop t"
    return allclose(kern.av, plain.av, what=f"{what} av", **tol)


def check_sweep_kernel_vs_plain(shape, dtype, n_steps=300,
                                cluster_size=None):
    """B3 (in the form cluster_size picks) against its plain version from
    one batched state over the same exact tables, in two chunks (the
    first odd): state and edges bit for bit, av at TOL, the dc-only
    point's av 0.  Returns (the largest abs difference of av, the
    runner)."""
    sweep, runner = _sweep_setup(shape, dtype, cluster_size=cluster_size)
    state0 = sweep._initial_states()
    kern, plain = state0.clone(), state0.clone()
    what = f"sweep {dtype} {shape} B={sweep.B} {runner.form}"
    err = 0.0
    n1 = n_steps // 2 + 1
    for n in (n1, n_steps - n1):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        launches0 = runner.launches
        kern = runner.advance(kern, n)
        plain = ssc.run_chunk_plain(sweep.consts, plain, xs, parity0,
                                    runner.egate)
        torch.cuda.synchronize()
        err = max(err, _sweep_chunk_checks(runner, kern, plain, launches0,
                                           n, what, TOL[dtype]))
    if shape in ("ragged", "ragged40"):
        assert bool((~runner.egate).any()), "no dc-only point"
    return err, runner


def check_omega_kernel_vs_plain(shape, dtype, n_steps=None, start=0,
                                cluster_size=None):
    """B3's per-omega mode against its plain version with the frames
    capture on, in two chunks (151 steps, so the second starts at parity
    1), from `start` steps into the sweep; n_steps=None runs to its end,
    past every loop exit.  State, edges and frames bit for bit, av and the
    capture sums at TOL.  Returns (largest abs difference of av, of the
    capture sums, the points whose capture fired, the runner)."""
    sweep, runner = _sweep_setup(shape, dtype, cluster_size=cluster_size)
    assert runner.per_omega, f"{shape}: not in per-omega mode"
    n_steps = n_steps or sweep.n_steps - start
    state0, cap0 = sweep._initial_states(), _zero_cap(sweep, frames=True)
    if start:
        state0, cap0 = runner.advance(state0, start, cap=cap0)
    kern, plain = state0.clone(), state0.clone()
    kcap = {k: v.clone() for k, v in cap0.items()}
    pcap = {k: v.clone() for k, v in cap0.items()}
    fired0 = cap0["norm"] != 0
    tol = TOL[dtype]
    what = f"omega {dtype} {shape} B={sweep.B} from {start} {runner.form}"
    err = cap_err = 0.0
    for n in (151, n_steps - 151):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        launches0 = runner.launches
        kern, kcap = runner.advance(kern, n, cap=kcap)
        plain, pcap = ssc.run_chunk_plain_omega(
            sweep.consts, plain, pcap, xs, parity0, runner.egate, runner.pp,
            runner.w_d4, runner.w_d4_phi)
        torch.cuda.synchronize()
        err = max(err, _sweep_chunk_checks(runner, kern, plain, launches0,
                                           n, what, tol))
        for k in stencil.CAP_KEYS:
            cap_err = max(cap_err, allclose(kcap[k], pcap[k],
                                            what=f"{what} capture {k}",
                                            **tol))
        for k in ("a", "b"):
            assert torch.equal(kcap[k], pcap[k]), f"{what}: frames {k}"
    fired = (kcap["norm"] != 0) & ~fired0
    assert torch.equal(fired, (pcap["norm"] != 0) & ~fired0), what
    assert bool(fired.any()), f"{what}: no loop-exit capture fired"
    assert bool(torch.all(kern.av[runner.egate, 0] > 0)), \
        f"{what}: a point never averaged"
    if start + n_steps == sweep.n_steps:
        assert bool(torch.all(kcap["norm"] != 0)), \
            f"{what}: a point's loop-exit capture never fired"
    if shape in ("omega_ragged", "omega_ragged40"):
        assert bool((~runner.egate).any()), "no dc-only point"
    return err, cap_err, int(fired.sum()), runner


def check_cluster_vs_streaming(shape):
    """B3's cluster form (the plan's) against its streaming form over the
    whole sweep from one state, f32, one launch a chunk: state and edges
    (per-omega mode: and the frames) bit for bit, av and the capture sums
    at TOL."""
    sweep, clu = _sweep_setup(shape, "f32")
    assert clu.form == "cluster", f"{shape}: the {clu.form} form"
    stm = ssc.SweepStackRunner(sweep, cluster_size=0)
    state0 = sweep._initial_states()
    n, tol = sweep.n_steps, TOL["f32"]
    if clu.per_omega:
        got, gcap = clu.advance(state0.clone(), n,
                                cap=_zero_cap(sweep, frames=True))
        ref, rcap = stm.advance(state0.clone(), n,
                                cap=_zero_cap(sweep, frames=True))
    else:
        got, ref = (r.advance(state0.clone(), n) for r in (clu, stm))
    torch.cuda.synchronize()
    assert clu.launches == stm.launches == _b3_chunk_launches(n)
    same_state(got, ref, f"{shape} cluster vs streaming")
    allclose(got.av, ref.av, what=f"{shape} av", **tol)
    if clu.per_omega:
        for k in stencil.CAP_KEYS:
            allclose(gcap[k], rcap[k], what=f"{shape} capture {k}", **tol)
        for k in ("a", "b"):
            assert torch.equal(gcap[k], rcap[k]), f"{shape}: frames {k}"


def expected_av_counts(sweep):
    """Each point's averaging-step count from the host schedule alone: the
    loop t of every step by sequential accumulation in the sweep's dtype,
    inside [t_start, t_start + T_p), for points with E_omega > 0."""
    D = sweep.base.np_dtype
    ts = schedule.accum_sequence(0.0, sweep.base.dt, sweep.n_steps - 1, D)
    t0 = D(sweep.cfg.t_start)
    return np.array([np.count_nonzero((ts >= t0) & (ts < D(t0 + m.T)))
                     if float(m.E_omega) > 0 else 0 for m in sweep.models],
                    float)


def run_sweep_cli(argv):
    """sweep_cli.main(argv) with every count set to 0 just before: (table
    text, the ParameterSweep, its results, {counter: launches} of B1, B3
    by mode and B3 by form)."""
    from slb2d_tpu_torch import sweep_cli
    from slb2d_tpu_torch.parallel import sweep as swmod
    seen = []
    finalize = swmod.ParameterSweep._finalize

    def keep(self, final, cap):
        res = finalize(self, final, cap)
        seen.append((self, res))
        return res

    swmod.ParameterSweep._finalize = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sweep.txt")
            tracing.reset()
            assert sweep_cli.main(argv + [f"o={path}"]) == 0
            with open(path) as fh:
                text = fh.read()
    finally:
        swmod.ParameterSweep._finalize = finalize
    assert len(seen) == 1
    launches = {k: tracing.counted(f"launches.{k}") for k in (
        "B1", "B3.shared", "B3.omega")}
    for form in ("cluster", "streaming"):
        launches[form] = sum(tracing.counted(f"launches.B3.{mode}.{form}")
                             for mode in ("shared", "omega"))
    return (text, *seen[0], launches)


def close_tables(res, ref, keys=OBS, **tol):
    """The observables of two sweeps' tables at tol (OBS_TOL), av counts
    exact."""
    np.testing.assert_array_equal(res["av_count"], ref["av_count"])
    for k in keys:
        np.testing.assert_allclose(np.asarray(res[k], float),
                                   np.asarray(ref[k], float), err_msg=k,
                                   **(tol or OBS_TOL))


def _lanes_runner(shape, max_points=16, cluster_size=None):
    """(sweep, its B4 runner) at one sweep check shape; cluster_size as
    LanesRunner takes it (None: lanes_cluster_plan's form, 0: the streaming
    form)."""
    sweep, _ = _sweep_setup(shape, "f32", impl="torch")
    return sweep, slc.make_sweep_lanes_runner(
        sweep, max_points=max_points, cluster_size=cluster_size)


def _lanes_call_launches(runner, n):
    if runner.form == "cluster":
        return slc.LAUNCHES_PER_CALL if n else 0
    return slc.LAUNCHES_PER_STEP * n


def _lanes_equal(x, y, what):
    if isinstance(x, np.ndarray):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(x, y), f"{what} not bit for bit"


def check_lanes_vs_plain(shape, max_points=16, n_steps=None, split=151,
                         cluster_size=None):
    """B4 (in the form cluster_size picks) against its plain version from
    each chunk's bootstrap, split across calls at step `split` (odd: the
    second call starts at parity 1 and its loop t continues); n_steps=None
    runs to the sweep's end.  State, per-lane av and capture rows and the
    host segment sums bit for bit; the launches per call of the form.
    Returns the runner."""
    sweep, runner = _lanes_runner(shape, max_points, cluster_size)
    n = n_steps or sweep.n_steps
    what = f"lanes {shape} max_points={max_points} {runner.form} {n} steps"
    sums = []
    for k, pack in enumerate(runner.packs):
        launches0 = runner.launches
        kern = runner.advance(k, runner.start(k), split)
        kern = runner.advance(k, kern, n - split, step0=split)
        plain = slc.run_lanes_plain(pack, runner.start(k), split)
        plain = slc.run_lanes_plain(pack, plain, n - split, split,
                                    runner.loop_t(split))
        torch.cuda.synchronize()
        assert runner.launches - launches0 == (
            _lanes_call_launches(runner, split)
            + _lanes_call_launches(runner, n - split)), what
        for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
            _lanes_equal(getattr(kern, f), getattr(plain, f),
                         f"{what} chunk {k} {f}")
        (kav, kcap, _), (pav, pcap, _) = (slc.finish_chunk(pack, kern),
                                          slc.finish_chunk(pack, plain))
        _lanes_equal(kav, pav, f"{what} av sums")
        _lanes_equal(kcap, pcap, f"{what} cap sums")
        sums.append((kav, kcap))
    av = np.concatenate([a for a, _ in sums])
    cap = np.concatenate([c for _, c in sums], axis=1)
    egate = np.array([float(m.E_omega) > 0 for m in sweep.models])
    assert bool(np.all(av[~egate] == 0)) and bool(np.all(av[egate, 0] > 0))
    if n == sweep.n_steps:
        np.testing.assert_array_equal(av[:, 0], expected_av_counts(sweep))
        assert bool(np.all(cap[3] != 0)), f"{what}: a capture never fired"
    return runner


def check_lanes_forms(shape, max_points):
    """B4's cluster form (the plan's) against its streaming form over the
    whole sweep from each chunk's bootstrap, one call per chunk: state,
    per-lane rows and host segment sums bit for bit.  Returns the
    cluster-form runner."""
    sweep, clu = _lanes_runner(shape, max_points)
    assert clu.form == "cluster", f"lanes {shape}: the {clu.form} form"
    stm = slc.make_sweep_lanes_runner(sweep, max_points=max_points,
                                      cluster_size=0)
    n = sweep.n_steps
    for k, pack in enumerate(clu.packs):
        got = clu.advance(k, clu.start(k), n)
        ref = stm.advance(k, stm.start(k), n)
        torch.cuda.synchronize()
        for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
            _lanes_equal(getattr(got, f), getattr(ref, f), f"chunk {k} {f}")
        for x, y in zip(slc.finish_chunk(pack, got)[:2],
                        slc.finish_chunk(pack, ref)[:2]):
            _lanes_equal(x, y, f"chunk {k} sums")
    assert clu.launches == len(clu.packs) * slc.LAUNCHES_PER_CALL
    assert stm.launches == len(clu.packs) * slc.LAUNCHES_PER_STEP * n
    return clu


# ---- single runs: the CLI, displays, goldens --------------------------------

@contextlib.contextmanager
def in_dir(path):
    """Run the block with `path` (created) as the working directory: the
    frame displays write their files there."""
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


def run_sim(cfg_kw, impl, repl=None):
    """A Simulation of SimConfig(**cfg_kw) with impl on the card, run in
    the working directory (its output in out.txt there); repl: a
    parameter-server script.  Returns the Simulation."""
    from slb2d_tpu_torch.runtime.loop import Simulation
    cfg = SimConfig(impl=impl, quiet=True, out_file="out.txt", **cfg_kw)
    sim = Simulation(cfg, device=torch.device(DEVICE))
    # the frames' `# norm=` echo (the reference's printf) stays off stdout
    with contextlib.redirect_stdout(io.StringIO()):
        sim.run(repl_stream=io.StringIO(repl) if repl is not None else None)
    return sim


def zero_counts():
    """Every kernel's launch count set to 0: the program's counters and
    the probes' own counts."""
    from slb2d_tpu_torch.perf import (roll_cost_experiment,
                                      transposed_experiment, vpu_roofline)
    tracing.reset()
    vpu_roofline.launch_count = 0
    roll_cost_experiment.register_launch_count = 0
    roll_cost_experiment.pass_launch_count = 0
    for k in ("launch_count", "resident_launch_count",
              "per_half_step_launch_count"):
        setattr(transposed_experiment, k, 0)


def counted(fn):
    """(fn(), launches): every kernel count set to 0 just before fn and
    read just after (bench.launch_counts, plus B2 by form)."""
    from slb2d_tpu_torch import bench
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    got = bench.launch_counts()
    got["B2 spill"] = tracing.counted("launches.B2.spill")
    got["B2 tiling"] = tracing.counted("launches.B2.tiling")
    return out, got


def only(launches, want):
    """The kernels named in want launched that often, every other none."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def rows_of(text):
    return np.array([l.split() for l in text.splitlines()
                     if l and not l.startswith("#")], float)


def cli_argv(shape, display=4, impl="cuda"):
    """MAIN_ARGV (BASELINE #4's physics) at another shape, display and
    impl."""
    return [a for a in MAIN_ARGV if a.split("=")[0] not in
            ("display", "n-harmonics", "g-grid", "impl")] + [
        f"display={display}", f"n-harmonics={shape['n_harmonics']}",
        f"g-grid={shape['g_grid']}", f"impl={impl}"]


def run_cli(argv, form=None):
    """cli.main(argv) under forced_form(form), through counted.  Returns
    (the output text, the launches)."""
    from slb2d_tpu_torch import cli
    with forced_form(form), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.txt")
        rc, launches = counted(lambda: cli.main(argv + [f"o={path}"]))
        assert rc == 0
        with open(path) as fh:
            return fh.read(), launches


def run_schedule(model, display, t_start=10.0):
    """(steps, chunks, display-77 records) of a CLI run of model at
    `display` from t=0 to t_start + T: the Simulation's schedule."""
    from slb2d_tpu_torch.runtime.loop import CUDA_CHUNK_DEFAULT
    D = model.np_dtype
    t_max = float(D(D(t_start) + model.T))
    chunks = list(schedule.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=t_max,
        t_start=t_start, E_omega=model.E_omega, display=display,
        frame_start=0.0, T=model.T, dtype=D, chunk_max=CUDA_CHUNK_DEFAULT,
        break_on_e77=False))
    return (schedule.count_steps(0.0, t_max, model.dt, D), chunks,
            sum(len(ch.emit_idx) for ch in chunks))


def expected_launches(engine, form, steps, chunks, records=0):
    """{kernel: launches} of a single run, as counted() reads them: B1
    resident and B2 spill one a chunk, B1 per-half-step three a step and
    one a display-77 record, B2 tiling two a K steps."""
    if engine == "stream":
        n = (stepper_cuda.LAUNCHES_PER_CHUNK * chunks if form == "spill"
             else sst.LAUNCHES_PER_LAUNCH * -(-steps // sst.DEFAULT_K))
        return {"B2": n, f"B2 {form}": n}
    n = (stepper_cuda.LAUNCHES_PER_CHUNK * chunks if form == "resident"
         else stepper_cuda.LAUNCHES_PER_STEP * steps + records)
    return {"B1": n, f"B1 {form}": n}


def _gold_lines(name):
    path = os.path.join(ROOT, "tests", "golden", name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read().splitlines()


# the displays' goldens at tests/test_golden.py's shapes and tolerances
# (N=8 M=24, omega=10): display 3 at t-max 0.5, (golden, dtype, rtol, atol,
# norm rtol); display 7 at t-max 0.2, (dtype, frames, rtol, atol); the
# line goldens, (golden, display, dtype, t-max, the parameter-server
# script or None, rtol, atol, the header lines compared): the recorded
# sessions, display 4 at BASELINE #1 (t-max 10), display 77
D3_GOLDENS = (("d3_tiny_f64.txt.gz", "f64", 1e-8, 1e-14, 1e-9),
              ("d3_tiny_f32.txt.gz", "f32", 2e-4, 5e-6, 2e-5))
D7_GOLDENS = (("f64", (1, 2), 1e-8, 1e-14), ("f32", (1, 12), 2e-4, 3e-6))
LINE_GOLDENS = (
    ("repl_f64.txt", 4, "f64", 0.5,
     "E_dc 1.5 0.5\nB 0.2 0.5\nmu 1.3 0.3\nomega 12.0 0.3\nexit\n",
     1e-8, 1e-12, "# display="),
    ("repl_fuzz_f64.txt", 4, "f64", 0.5,
     "E_dc 1.5x 0.40\nbogus 7 0.30\nB .25e0 0.35\nexit 0.9 0.30\n"
     "mu abc 1.1 0.25\nexit\n", 1e-8, 1e-12, "# display="),
    ("repl_d77_f64.txt.gz", 77, "f64", 0.3, "E_dc 1.6 0.2\nexit\n", 5e-9,
     1e-12, "# display="),
    ("d4_base1_f64.txt", 4, "f64", 10.0, None, 1e-8, 1e-9, "#"),
    ("d4_base1_f32.txt", 4, "f32", 10.0, None, 2e-5, 8e-6, "#"),
    ("d77_tiny_f32_fixed.txt.gz", 77, "f32", 0.2, None, 2e-4, 8e-6, None),
    ("d77_tiny_f64_fixed.txt.gz", 77, "f64", 0.2, None, 5e-9, 1e-12, None))
TINY_DISPLAY = dict(n_harmonics=8, g_grid=24, **{**PHYS, "omega": 10.0})
FORM_TAGS = {None: None, "per-half-step": "cuda-b1 per-half-step",
             "tiling": "stream tiling", "spill": "stream spill"}


def _took(sim, impl, form, what):
    tag = sim.engine_tag()
    want = FORM_TAGS[form] or ("cuda-b1 resident" if impl == "cuda"
                               else "stream tiling")
    assert tag == want, f"{what} impl={impl}: ran on {tag}, not {want}"


def displays_golden(impl, form, tmp, bands=2):
    """Displays 3, 4, 7 and 77 and the three parameter-server sessions
    through impl on `form` (see forced_form) against the reference C
    solver's recorded output, at tests/test_golden.py's tolerances with
    the headers byte for byte; checks the run took that form.  Returns
    {golden: max abs err}."""
    errs = {}
    with forced_form(form, bands):
        for gold, dtype, rtol, atol, nrtol in D3_GOLDENS:
            with in_dir(os.path.join(tmp, f"d3{dtype}")):
                sim = run_sim(dict(display=3, dtype=dtype, t_start=0.5,
                                   **TINY_DISPLAY), impl)
                with open("out.txt") as fh:
                    mine = fh.read().splitlines()
            _took(sim, impl, form, gold)
            ref = _gold_lines(gold)
            assert len(ref) == len(mine), f"{gold}: {len(mine)} lines"
            vals, rvals = [], []
            for g, m in zip(ref, mine):
                if g.startswith("# norm="):
                    allclose(float(m[7:]), float(g[7:]), nrtol, 0.0,
                           f"{gold} norm")
                    continue
                assert g.split()[:2] == m.split()[:2], f"{gold}: coordinates"
                vals.append(m.split()[2:])
                rvals.append(g.split()[2:])
            errs[gold] = allclose(np.array(vals, float), np.array(rvals, float),
                                rtol, atol, gold)
        for dtype, frames, rtol, atol in D7_GOLDENS:
            d = os.path.join(tmp, f"d7{dtype}")
            with in_dir(d):
                sim = run_sim(dict(display=7, dtype=dtype, t_start=0.2,
                                   **TINY_DISPLAY), impl)
            M = TINY_DISPLAY["g_grid"]
            for idx in frames:
                gold = f"d7_frame{idx}_{dtype}.txt.gz"
                _took(sim, impl, form, gold)
                ref = [l for l in _gold_lines(gold) if not l.startswith("#")]
                with open(os.path.join(d, f"frame{idx:08d}.data")) as fh:
                    mine = [l for l in fh.read().splitlines()
                            if not l.startswith("#")]
                n_gold, n_mine = 2 * M + 1, M + 1   # OOB rows in the gold
                blocks = len(ref) // n_gold
                assert len(mine) == blocks * n_mine, f"{gold}: rows"
                vals, rvals = [], []
                for b in range(blocks):
                    for g, m in zip(ref[b * n_gold: b * n_gold + n_mine],
                                    mine[b * n_mine: (b + 1) * n_mine]):
                        assert g.split()[:2] == m.split()[:2], gold
                        vals.append(float(m.split()[2]))
                        rvals.append(float(g.split()[2]))
                errs[gold] = allclose(vals, rvals, rtol, atol, gold)
        for gold, display, dtype, t_max, script, rtol, atol, head in (
                LINE_GOLDENS):
            grid = ({**BASELINE1, **PHYS} if gold.startswith("d4_")
                    else TINY_DISPLAY)
            with in_dir(os.path.join(tmp, gold.split(".")[0])):
                sim = run_sim(dict(display=display, dtype=dtype,
                                   t_start=t_max, **grid, **(
                                       {"read_from": "stdin"} if script
                                       else {})), impl, repl=script)
                with open("out.txt") as fh:
                    mine = fh.read().splitlines()
            _took(sim, impl, form, gold)
            ref = _gold_lines(gold)
            rows, want = rows_of("\n".join(mine)), rows_of("\n".join(ref))
            assert len(rows) == len(want), f"{gold}: {len(rows)} lines"
            assert len(rows) == 1 if gold.startswith("d4_") else (
                len(rows) > (4 if script else 50)), f"{gold}: lines"
            if display == 77 and script is None:    # t bit for bit
                np.testing.assert_array_equal(rows[:, 13], want[:, 13])
            errs[gold] = allclose(rows, want, rtol, atol, gold)
            assert head is None or ([l for l in ref if l.startswith(head)]
                                    == [l for l in mine
                                        if l.startswith(head)]), \
                f"{gold}: headers differ"
    return errs


def device_frame_vs_host(dtype="f32", n_steps=2000):
    """The device frame (ops/frames.reconstruct_on_device, in the state's
    dtype) against the host f64 frame from the same state, BASELINE #3's
    grid after n_steps on B1: f32 at the D7 envelope, f64 at TOL["f64"];
    the norm sums likewise (f32 at rtol 1e-5).  Returns (max abs err, the
    frame's shape)."""
    from slb2d_tpu_torch.ops import frames
    cfg = SimConfig(display=7, dtype=dtype, **BASELINE3, **MOVIE)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, torch.device(DEVICE))
    state = stepper_cuda.make_cuda_runner(c, model, av_enabled=False)(
        stencil.bootstrap_state(c, model), n_steps)
    recon = frames.FrameReconstructor(model)
    F, ns = recon.reconstruct_on_device(state.a, state.b, 1, model.M + 2)
    assert F.dtype == state.a.dtype, f"{dtype} device frame in {F.dtype}"
    a, b = state.a.cpu().numpy(), state.b.cpu().numpy()
    ref = recon.reconstruct(a, b, 1, model.M + 2)
    tol = FRAME_TOL if dtype == "f32" else TOL["f64"]
    err = allclose(F.cpu().numpy(), ref, what=f"{dtype} device frame", **tol)
    allclose(float(ns), float((a[0].astype("float64") * model.w_norm).sum()),
           1e-5 if dtype == "f32" else TOL["f64"]["rtol"], 0.0,
           f"{dtype} device norm sum vs host f64")
    return err, tuple(F.shape)


def check_schedule_vs_plain(cfg_kw, what, max_chunks=None):
    """A Simulation's own chunks (its schedule's tables, av off at
    displays 7 and 8) through the B1 runner it builds, against B1's plain
    version from the same bootstrap state; a chunk of more than 16 steps
    cut at an odd step.  State bit for bit after every chunk.  The first
    max_chunks chunks, or all.  Returns (the kernel's state, steps)."""
    from slb2d_tpu_torch.runtime.loop import Simulation
    sim = Simulation(SimConfig(impl="cuda", quiet=True, **cfg_kw),
                     out=io.StringIO(), device=torch.device(DEVICE))
    runner = sim._kernel_runner()
    kern, plain = sim.state, sim.state.clone()
    av_off = cfg_kw["display"] in (7, 8)
    steps = 0
    for i, chunk in enumerate(schedule.iter_chunks(
            **sim._schedule_kwargs())):
        if i == max_chunks:
            break
        assert not av_off or not chunk.xs["do_av"].any(), what
        n = chunk.n_steps
        cut = (n // 2) | 1 if n > 16 else n
        for lo, hi in ((0, cut), (cut, n)):
            if lo == hi:
                continue
            part = {k: v[lo:hi] for k, v in chunk.xs.items()}
            kern = runner.run_xs(kern, part, steps % 2)
            plain, _ = stepper_cuda.run_chunk_plain(
                sim.c, plain, stepper_cuda.pack_xs_dict(
                    part, sim.model.np_dtype), steps % 2)
            steps += hi - lo
        _state_equal(kern, plain, f"{what} after chunk {i}")
    assert runner.form == "resident" and runner.launches > 0, what
    assert not av_off or not bool(kern.av.any()), f"{what}: av moved"
    return kern, steps


# ---- shards and the combined layout ----------------------------------------

def _shard_setup(shape, dtype, S, **kw):
    """(model, consts, xs, layout, sharded runner) at one shape on S slots
    of the card."""
    from slb2d_tpu_torch.parallel.mesh import make_mesh
    from slb2d_tpu_torch.parallel.spatial import SpaceLayout
    from slb2d_tpu_torch.parallel.stream_shard import ShardedStreamRunner
    model, c, xs = _setup(shape, dtype)
    lay = SpaceLayout(make_mesh((S,), ("space",), devices=[DEVICE] * S),
                      model.MP)
    return model, c, xs, lay, ShardedStreamRunner(lay.scatter_consts(c),
                                                  model, lay, **kw)


def check_shard_vs_plain(shape, dtype, S):
    """B2's sharded form on S slots of the card against its plain version
    (_vs_stream_plain; S + 1 launches a round).  Returns (largest abs
    difference, runner)."""
    from slb2d_tpu_torch.parallel.stream_shard import (
        run_chunk_plain_stream_sharded)
    model, c, xs, lay, runner = _shard_setup(shape, dtype, S)
    err = _vs_stream_plain(
        model, c, xs, runner,
        lambda *a: run_chunk_plain_stream_sharded(*a, lay), S + 1,
        f"stream sharded S={S} {dtype} {shape} {tuple(runner.geom)}", dtype,
        lay.scatter_state, lay.gather_state)
    return err, runner


def held_tensors(root):
    """(path, tensor) of every tensor reachable from root's attributes,
    dataclass fields, dicts, lists, tuples and Slots (objects of the
    slb2d_tpu_torch package only)."""
    from slb2d_tpu_torch.parallel.spatial import Slots
    seen, out = set(), []

    def walk(x, path):
        if id(x) in seen or isinstance(x, (str, bytes, int, float,
                                           np.ndarray, type(None))):
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append((path, x))
        elif isinstance(x, Slots):
            for i, v in enumerate(x.items):
                walk(v, f"{path}[{i}]")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif dataclasses.is_dataclass(x) or hasattr(x, "__dict__"):
            if type(x).__module__.startswith("slb2d_tpu_torch"):
                for k, v in vars(x).items():
                    walk(v, f"{path}.{k}")

    walk(root, "")
    return out
