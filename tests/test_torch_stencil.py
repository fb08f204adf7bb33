"""The port's plain PyTorch stencil against the JAX stencil and the C oracle.

Both packages start from the same state (a JAX State carried across with
state_from_numpy) and the same host schedule.  Tolerances: f64 at
rtol=1e-12 with atol=1e-14 (the two differ only in reduction order and
XLA's FMA contraction; the atol term covers entries that cancel to ~1e-17
where the other side holds an exact 0, against field values of ~0.1);
f32 at rtol=1e-4, atol=1e-7 (the interpreter-vs-scan envelope of
tests/test_pallas.py: ulp-level rounding differences of the same class
as docs/DEVIATIONS.md D7, compounded over hundreds of steps).  The staleness carries (hs_edge_*) and the parity ghost
fill are copies and adds of exact values, so they are pinned bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.runtime import schedule as jsched

from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel as TModel
from slb2d_tpu_torch.ops import stencil as ts

from tests.oracle.c_transcription import CTranscription

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.1, g_grid=64, dt=1e-3, quiet=True)

TOL = {"f64": dict(rtol=1e-12, atol=1e-14),
       "f32": dict(rtol=1e-4, atol=1e-7)}

CPU = torch.device("cpu")


def build(dtype):
    jm = JModel(JConfig(**CFG, dtype=dtype))
    tm = TModel(TConfig(**CFG, dtype=dtype))
    return jm, js.consts_from_model(jm), tm, ts.consts_from_model(tm, CPU)


def jax_state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def schedule_xs(model, n):
    chunks = list(jsched.iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=1.0,
        t_start=model.cfg.t_start, E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=10**9))
    assert chunks[0].n_steps >= n
    return {k: v[:n] for k, v in chunks[0].xs.items()}


def assert_state_close(tstate, jstate, tol, fields=js.State._fields):
    got = ts.state_to_numpy(tstate)
    for f in fields:
        ref = np.asarray(getattr(jstate, f))
        assert got[f].dtype == ref.dtype, f
        np.testing.assert_allclose(got[f], ref, err_msg=f, **tol)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("main", [True, False])
@pytest.mark.parametrize("recip", [False, True])
def test_apply_half_step_matches_jax(dtype, main, recip):
    jm, jc, tm, tc = build(dtype)
    D = jm.np_dtype
    rng = np.random.default_rng(11)
    arrs = [(rng.standard_normal((jm.NHP, jm.MP)) * 0.1).astype(D)
            for _ in range(4)]
    cos_t, cos_t_dt = (D(x) for x in rng.uniform(-1, 1, 2))
    ref = js.apply_half_step(jc, *arrs, cos_t, cos_t_dt, main=main,
                             use_reciprocal=recip)
    got = ts.apply_half_step(tc, *(torch.from_numpy(x) for x in arrs),
                             float(cos_t), float(cos_t_dt), main=main,
                             use_reciprocal=recip)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.float64 if dtype == "f64"
                           else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_bootstrap_state_matches_jax(dtype):
    jm, jc, tm, tc = build(dtype)
    assert_state_close(ts.bootstrap_state(tc, tm),
                       js.bootstrap_state(jc, jm), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_full_step_300_steps_matches_jax(dtype):
    jm, jc, tm, tc = build(dtype)
    xs = schedule_xs(jm, 300)
    assert xs["do_av"].any() and not xs["do_av"].all()
    j0 = js.bootstrap_state(jc, jm)
    step = js.make_step_fn(jc, av_enabled=True, exact_trig=True)
    jout = jax.jit(lambda s, x: jax.lax.scan(step, s, x)[0])(j0, xs)
    t0 = ts.state_from_numpy(jax_state_np(j0), CPU)
    tout, ys = ts.run_chunk(tc, t0, xs, collect_obs=False)
    assert ys is None
    assert_state_close(tout, jout, TOL[dtype])
    assert int(tout.step) == 300


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_av_update_matches_jax(dtype):
    jm, jc, tm, tc = build(dtype)
    D = jm.np_dtype
    rng = np.random.default_rng(5)
    a, b = ((rng.standard_normal((jm.NHP, jm.MP)) * 0.1).astype(D)
            for _ in range(2))
    av = rng.standard_normal(8).astype(D)
    av[0] = 12
    cos_av, sin_av = D(0.3), D(-0.7)
    ref = js.av_update(jc, av, a, b, cos_av, sin_av)
    got = ts.av_update(tc, torch.from_numpy(av), torch.from_numpy(a),
                       torch.from_numpy(b), float(cos_av), float(sin_av))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL[dtype])


def test_emission_record_and_device_trig_match_jax():
    jm, jc, tm, tc = build("f64")
    xs = schedule_xs(jm, 40)
    j0 = js.bootstrap_state(jc, jm)
    step = js.make_step_fn(jc, av_enabled=True, exact_trig=True,
                           collect_obs=True)
    _, jys = jax.jit(lambda s, x: jax.lax.scan(step, s, x))(j0, xs)
    t0 = ts.state_from_numpy(jax_state_np(j0), CPU)
    _, tys = ts.run_chunk(tc, t0, xs, collect_obs=True)
    assert tys.shape == (40, 13)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), **TOL["f64"])
    t = np.float64(0.123)
    for g, r in zip(ts.device_trig(tc, torch.tensor(t)),
                    js.device_trig(jc, t)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-15)


def test_edges_and_ghost_fill_bit_for_bit_f64():
    jm, jc, tm, tc = build("f64")
    xs = schedule_xs(jm, 9)
    jstate = js.bootstrap_state(jc, jm)
    tstate = ts.state_from_numpy(jax_state_np(jstate), CPU)
    M = jm.M
    ghost = jm.a0_ghost != 0
    for i in range(9):
        trig = tuple(xs[k][i] for k in ts.XS_TRIG)
        jstate = js.full_step(jc, jstate, trig, bool(xs["do_av"][i]))
        tstate = ts.full_step(tc, tstate, tuple(float(v) for v in trig),
                              bool(xs["do_av"][i]))
        got = ts.state_to_numpy(tstate)
        for f in ("hs_edge_a", "hs_edge_b"):
            np.testing.assert_array_equal(got[f], np.asarray(
                getattr(jstate, f)), err_msg=f)
        for f in ("a_hs", "b_hs"):
            np.testing.assert_array_equal(
                got[f][:, M + 1], np.asarray(getattr(jstate, f))[:, M + 1])
        # ghost cells: a0 after even step counts, 0 after odd ones
        np.testing.assert_array_equal(got["a"][ghost],
                                      np.asarray(jstate.a)[ghost])
        expect = jm.a0_ghost[ghost] if (i + 1) % 2 == 0 else 0
        np.testing.assert_array_equal(got["a"][ghost], expect)


def test_state_numpy_round_trip():
    jm, jc, tm, tc = build("f32")
    st = ts.bootstrap_state(tc, tm)
    d = ts.state_to_numpy(st)
    back = ts.state_from_numpy(d, CPU)
    for f in ts.FIELDS:
        assert torch.equal(getattr(st, f), getattr(back, f)), f
    assert back.step.dtype == torch.int32 and back.t.shape == ()


# ---- the C oracle, pinned as tests/test_stencil_vs_oracle.py pins it ------

f32 = np.float32
f64 = np.float64

PARAMS = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9,
              B=0.4, t_start=0.01)
TINY = dict(n_harmonics=6, g_grid=12, dt=1e-3)


def make_pair():
    cfg = TConfig(display=4, phi_y_min=-3.0, phi_y_max=3.0, **PARAMS, **TINY)
    model = TModel(cfg)
    c = ts.consts_from_model(model, CPU)
    state = ts.bootstrap_state(c, model)
    oracle = CTranscription(
        N=TINY["n_harmonics"], M=TINY["g_grid"], dt=TINY["dt"],
        PhiYmin=-3.0, PhiYmax=3.0, **PARAMS)
    return model, c, state, oracle


def host_trig(oracle, t):
    om, dt = oracle.omega, oracle.dt
    t_hs = f32(t + dt / 2)
    return tuple(float(v) for v in (
        f32(np.cos(f64(f32(om * t)))),
        f32(np.cos(f64(f32(om * f32(t + dt))))),
        f32(np.cos(f64(f32(om * t_hs)))),
        f32(np.cos(f64(f32(om * f32(t_hs + dt))))),
        f32(np.cos(f64(f32(om * t)))),
        f32(np.sin(f64(f32(om * t)))),
    ))


def unpad(model, arr):
    return arr.numpy()[:model.NH, :model.MS]


def test_oracle_bootstrap_matches():
    model, c, state, oracle = make_pair()
    np.testing.assert_array_equal(unpad(model, state.a), oracle.a[0])
    np.testing.assert_allclose(unpad(model, state.a_hs), oracle.a[2],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(unpad(model, state.b_hs), oracle.b[2],
                               rtol=1e-6, atol=1e-9)
    assert np.all(state.a_hs.numpy()[model.NH:, :] == 0)
    assert np.all(state.a_hs.numpy()[:, model.MS:] == 0)


@pytest.mark.parametrize("n_steps", [1, 2, 3, 25])
def test_oracle_steps_match_transcription(n_steps):
    model, c, state, oracle = make_pair()
    for _ in range(n_steps):
        state = ts.full_step(c, state, host_trig(oracle, oracle.t), True)
        oracle.run_steps(1, do_av="always")
    cur, ch = oracle.current, oracle.current_hs
    tol = dict(rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(unpad(model, state.a), oracle.a[cur], **tol)
    np.testing.assert_allclose(unpad(model, state.b), oracle.b[cur], **tol)
    np.testing.assert_allclose(unpad(model, state.a_hs), oracle.a[ch], **tol)
    np.testing.assert_allclose(unpad(model, state.b_hs), oracle.b[ch], **tol)
    np.testing.assert_allclose(state.av.numpy()[:6], oracle.av_data,
                               rtol=2e-5, atol=1e-9)


def test_oracle_hs_edge_column_staleness():
    """Column M+1 of the half-step arrays alternates between its bootstrap
    value and 0 (the reference's 4-buffer rotation)."""
    model, c, state, oracle = make_pair()
    e = model.M + 1
    boot_col = state.a_hs.numpy()[:, e].copy()
    assert np.any(boot_col != 0)
    for k in range(1, 6):
        state = ts.full_step(c, state, host_trig(oracle, oracle.t), False)
        oracle.run_steps(1)
        np.testing.assert_allclose(
            state.a_hs.numpy()[:model.NH, e],
            oracle.a[oracle.current_hs][:, e], rtol=1e-6, atol=1e-12)
        expected = boot_col if k % 2 == 0 else np.zeros_like(boot_col)
        np.testing.assert_array_equal(state.a_hs.numpy()[:, e], expected)
