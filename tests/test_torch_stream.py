"""The port's temporal-tiling runner (ops/stepper_stream_cuda.py, kernel B2)
and impl=stream against the JAX package's stream engine.

On the CPU the port's StreamRunner runs the kernel's plain version
(run_chunk_plain_stream: the same tiles, stepped as one batch) and the JAX
stream runner runs its Pallas kernel in interpret mode, as
tests/test_stream.py runs it.  Small tiles (K=8, W=128) give one to three
tiles: a single tile with both halos outside the grid, ragged padding,
partial launches.  Tolerances: f32 against the JAX runner at
tests/test_stream.py's rtol 1e-4, atol 5e-7 (interpreter ulp class and the
tiles' sum order), edges bit for bit; f64 against the JAX XLA scan at rtol
1e-12 (the reciprocal form against the division); display-77 lines against
the reference goldens at tests/test_golden.py's tolerances.

The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax

from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.stepper_stream import make_stream_runner as jax_runner
from slb2d_tpu.runtime import checkpoint as jckpt
from slb2d_tpu.runtime.loop import Simulation as JSimulation
from slb2d_tpu.runtime.schedule import iter_chunks

from slb2d_tpu_torch.config import SimConfig, parse_cmd
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import _build, stepper_cuda
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import stepper_stream_cuda as ssc
from slb2d_tpu_torch.runtime import checkpoint as tckpt
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import read_gold

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.1, g_grid=300, dt=1e-3, quiet=True)
CPU = torch.device("cpu")
GRIDS = [(300, 8),      # 3 tiles at W=128
         (24, 8),       # one tile, both halos outside the grid
         (130, 18)]     # MP=256: 2 tiles, NHP=24


def build(dtype, **kw):
    jm = JModel(JConfig(**{**CFG, **kw}, dtype=dtype))
    tm = SuperlatticeModel(SimConfig(**{**CFG, **kw}, dtype=dtype))
    return jm, js.consts_from_model(jm), tm, ts.consts_from_model(tm, CPU)


def sched_xs(model, n, t_max):
    chunks = list(iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=t_max,
        t_start=CFG["t_start"], E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=10**9))
    return {k: v[:n] for k, v in chunks[0].xs.items()}


def to_port(jstate):
    return ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)


def assert_state_close(tstate, jstate, rtol, atol, exact_edges=True):
    got = ts.state_to_numpy(tstate)
    for f in ("a", "b", "a_hs", "b_hs", "av"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    for f in ("hs_edge_a", "hs_edge_b"):
        ref = np.asarray(getattr(jstate, f))
        if exact_edges:
            np.testing.assert_array_equal(got[f], ref, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], ref, rtol=rtol, atol=atol,
                                       err_msg=f)


def two_chunks(runner, state, xs, n1=103):
    out = runner.run_xs(state, {k: v[:n1] for k, v in xs.items()}, 0)
    return runner.run_xs(out, {k: v[n1:] for k, v in xs.items()}, n1 % 2)


@pytest.mark.parametrize("g_grid,n_harmonics", GRIDS)
def test_plain_matches_jax_stream_runner(g_grid, n_harmonics):
    jm, jc, tm, tc = build("f32", g_grid=g_grid, n_harmonics=n_harmonics)
    xs = sched_xs(jm, 160, 0.161)
    j0 = js.bootstrap_state(jc, jm)
    t0 = to_port(j0)                  # the JAX runner donates j0
    jout = two_chunks(jax_runner(jc, jm, K=8, W=128), j0, xs)
    runner = ssc.make_stream_runner(tc, tm, K=8, W=128)
    assert runner.geom.n_tiles == -(-tm.MP // 128)
    tout = two_chunks(runner, t0, xs)
    assert_state_close(tout, jout, rtol=1e-4, atol=5e-7)
    assert int(tout.step) == int(jout.step) == 160
    assert float(tout.t) == float(jout.t)
    assert runner.launches == 0 and _build._LOADED is None


@pytest.mark.parametrize("g_grid,n_harmonics", GRIDS)
def test_plain_f64_matches_jax_scan(g_grid, n_harmonics):
    """The exactness of the tiling, the halos and the edge ownership: the
    f64 plain version against the XLA scan over the same table."""
    jm, jc, tm, tc = build("f64", g_grid=g_grid, n_harmonics=n_harmonics)
    xs = sched_xs(jm, 160, 0.161)
    step = js.make_step_fn(jc, av_enabled=True, exact_trig=True)
    ref = jax.jit(lambda s, x: jax.lax.scan(step, s, x)[0])(
        js.bootstrap_state(jc, jm), xs)
    tout = two_chunks(ssc.make_stream_runner(tc, tm, K=8, W=128),
                      ts.bootstrap_state(tc, tm), xs)
    assert_state_close(tout, ref, rtol=1e-12, atol=1e-15, exact_edges=False)


def test_plain_matches_step_kernel_plain_bit_for_bit():
    """The default geometry (W=2H=32: several tiles) gives the B1 plain
    version's state bit for bit: the centers are the whole grid's cells
    with the same arithmetic."""
    for dtype in ("f32", "f64"):
        jm, jc, tm, tc = build(dtype)
        xs = sched_xs(jm, 61, 0.062)
        stream = ssc.make_stream_runner(tc, tm)
        assert stream.geom.W == 2 * stream.geom.H and stream.geom.n_tiles > 3
        s0 = ts.bootstrap_state(tc, tm)
        a = two_chunks(stream, s0, xs, n1=27)
        b = two_chunks(stepper_cuda.make_cuda_runner(tc, tm), s0, xs, n1=27)
        for f in ts.FIELDS:
            if f != "av":
                assert torch.equal(getattr(a, f), getattr(b, f)), (dtype, f)
        np.testing.assert_allclose(a.av.numpy(), b.av.numpy(),
                                   rtol=1e-5 if dtype == "f32" else 1e-13)


def test_d77_records_match_jax_emission_record():
    """Records replayed from the tiles' sums against the XLA scan's
    per-step emission_record and the JAX stream runner's records."""
    jm, jc, tm, tc = build("f32")
    xs = sched_xs(jm, 120, 0.121)
    emit = [0, 9, 19, 29, 119]
    xs["do_av"] = xs["do_av"].copy()
    xs["do_av"][emit] = True
    j0 = js.bootstrap_state(jc, jm)
    runner = ssc.make_stream_runner(tc, tm, K=8, W=128)
    out = runner.run_xs(to_port(j0), xs, 0, emit_idx=emit)
    recs = runner.take_obs(len(emit))
    assert recs.shape == (5, 13)
    step = js.make_step_fn(jc, av_enabled=True, exact_trig=True,
                           collect_obs=True)
    ref, ys = jax.jit(lambda s, x: jax.lax.scan(step, s, x))(j0, xs)
    np.testing.assert_array_equal(recs[:, 4], np.asarray(ys)[emit, 4])
    np.testing.assert_allclose(recs, np.asarray(ys)[emit], rtol=2e-4,
                               atol=1e-7)
    jr = jax_runner(jc, jm, K=8, W=128)
    jr.run_xs(j0, xs, 0, emit_idx=emit)
    np.testing.assert_allclose(recs, jr.take_obs(len(emit)), rtol=1e-4,
                               atol=5e-7)
    assert_state_close(out, ref, rtol=1e-4, atol=5e-7)


def test_parity_ghost_across_chunks():
    """The parity ghost fill continues across odd chunks and partial
    launches (tests/test_stream.py's case on the port)."""
    jm, jc, tm, tc = build("f32", g_grid=24)
    runner = ssc.make_stream_runner(tc, tm, K=8, W=128)
    xs = sched_xs(jm, 14, 0.015)
    out = runner.run_xs(ts.bootstrap_state(tc, tm),
                        {k: v[:7] for k, v in xs.items()}, 0)
    out = runner.run_xs(out, {k: v[7:13] for k, v in xs.items()}, 1)
    assert torch.all(out.a[:, 0] == 0)          # 13 steps: ghosts zero
    out = runner.run_xs(out, {k: v[13:14] for k, v in xs.items()}, 1)
    np.testing.assert_array_equal(out.a[:, 0].numpy(), tm.a0[:, 0])
    with pytest.raises(ValueError, match="parity"):
        runner.run_xs(out, {k: v[:3] for k, v in xs.items()}, 1)


def test_geometry_and_runner_surface():
    # the H100 shapes of the slice: shared memory where four tiles fit
    g = ssc.default_geometry(104, 12032, 4)
    assert (g.K, g.H, g.smem) == (4, 8, True) and g.n_tiles <= 132
    assert 4 * 104 * g.WT * 4 + 2 * 104 * 4 <= ssc.SMEM_BUDGET
    tall = ssc.default_geometry(408, 4096, 4)       # fits at W < 4H
    assert tall.smem and 2 * tall.H <= tall.W < 4 * tall.H
    assert not ssc.default_geometry(408, 4096, 8).smem   # f64: global
    assert ssc.default_geometry(16, 128, 8, K=4, W=128).H == 8
    with pytest.raises(ValueError, match="K="):
        ssc.default_geometry(16, 128, 4, K=33)
    # __call__ tables and t/parity tracking as the B1 runner's
    jm, jc, tm, tc = build("f64")
    s0 = ts.bootstrap_state(tc, tm)
    stream = ssc.make_stream_runner(tc, tm)
    b1 = stepper_cuda.make_cuda_runner(tc, tm)
    a, b = stream(s0, 21), b1(s0, 21)
    a, b = stream(a, 10), b1(b, 10)
    assert torch.equal(a.a, b.a) and torch.equal(a.t, b.t)
    assert stream.step0 == b1.step0 == 31 and stream.t0 == b1.t0
    assert stream.engine == "stream" and stream.launches == 0
    meta = s0.replace(a=s0.a.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        stream(meta, 4)


def _port_lines(tmp_path, monkeypatch, name, **kw):
    monkeypatch.chdir(tmp_path)
    cfg = SimConfig(**{**CFG, **kw}, out_file=f"{name}.txt")
    sim = Simulation(cfg, device=CPU)
    sim.run()
    text = (tmp_path / f"{name}.txt").read_text()
    return sim, [np.array(l.split(), float) for l in text.splitlines()
                 if l and not l.startswith("#")]


def _jax_lines(tmp_path, monkeypatch, name, **kw):
    monkeypatch.chdir(tmp_path)
    JSimulation(JConfig(**{**CFG, **kw}, out_file=f"{name}.txt")).run()
    text = (tmp_path / f"{name}.txt").read_text()
    return [np.array(l.split(), float) for l in text.splitlines()
            if l and not l.startswith("#")]


@pytest.mark.parametrize("display,dtype", [(4, "f32"), (4, "f64"),
                                           (77, "f32"), (77, "f64")])
def test_simulation_impl_stream_matches_jax(tmp_path, monkeypatch, display,
                                            dtype):
    """impl=stream device=cpu through the driver against the JAX driver:
    impl=stream in f32 (rtol 2e-4, atol 1e-6, tests/test_stream.py's),
    impl=xla in f64 (rtol 1e-10: the reciprocal form against the
    division over a few hundred steps).  Display-77 times bit for bit."""
    kw = dict(display=display, dtype=dtype, t_start=0.2,
              g_grid=200 if display == 4 else 64)
    sim, port = _port_lines(tmp_path, monkeypatch, "port", impl="stream",
                            **kw)
    assert sim.engine == "stream"
    ref = _jax_lines(tmp_path, monkeypatch, "jax",
                     impl="stream" if dtype == "f32" else "xla", **kw)
    assert len(port) == len(ref) >= (1 if display == 4 else 10)
    tol = (dict(rtol=2e-4, atol=1e-6) if dtype == "f32"
           else dict(rtol=1e-10, atol=1e-13))
    for p, r in zip(port, ref):
        if display == 77:
            assert p[13] == r[13]
        np.testing.assert_allclose(p, r, **tol)


@pytest.mark.parametrize("impl", ["torch", "stream"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_display77_vs_reference(tmp_path, monkeypatch, impl, dtype):
    """All 15 display-77 columns against the D1/D2-patched reference
    build (tests/test_golden.py:135-202): f32 rtol 2e-4 atol 8e-6, f64
    rtol 5e-9 atol 1e-12; t bit for bit."""
    gold = read_gold(f"d77_tiny_{dtype}_fixed.txt.gz")
    gold = [np.array(l.split(), float) for l in gold.splitlines()
            if l and not l.startswith("#")]
    _, mine = _port_lines(tmp_path, monkeypatch, "d77", display=77,
                          dtype=dtype, impl=impl, omega=10.0, n_harmonics=8,
                          g_grid=24, t_start=0.2, E_dc=1.0)
    assert len(gold) == len(mine) > 50
    tol = (dict(rtol=2e-4, atol=8e-6) if dtype == "f32"
           else dict(rtol=5e-9, atol=1e-12))
    for g, m in zip(gold, mine):
        assert g.shape == m.shape == (15,)
        assert m[13] == g[13]
        np.testing.assert_allclose(m, g, **tol)


def test_impl_stream_parses_and_checkpoints_cross_load(tmp_path,
                                                       monkeypatch):
    """impl=stream parses; a checkpoint written by a port stream run loads
    in the JAX package and one written by a JAX stream run loads in the
    port, both equal to the writer's state; the two runs' states agree at
    the f32 tolerance."""
    argv = ["display=4", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.1", "g-grid=300", "impl=stream"]
    assert parse_cmd(argv).impl == "stream"
    kw = dict(t_start=0.1, impl="stream", dtype="f32")
    sim, _ = _port_lines(tmp_path, monkeypatch, "p", checkpoint="p.npz",
                         **kw)
    _jax_lines(tmp_path, monkeypatch, "j", checkpoint="j.npz", **kw)
    jm = JModel(JConfig(**{**CFG, "dtype": "f32"}))
    tm = SuperlatticeModel(SimConfig(**{**CFG, "dtype": "f32"}))
    port_in_jax, _ = jckpt.load_state(str(tmp_path / "p.npz"), jm)
    jax_in_port, _ = tckpt.load_state(str(tmp_path / "j.npz"), tm)
    port_own, _ = tckpt.load_state(str(tmp_path / "p.npz"), tm)
    jax_own, _ = jckpt.load_state(str(tmp_path / "j.npz"), jm)
    mine = ts.state_to_numpy(sim.state)
    for f in js.State._fields:
        np.testing.assert_array_equal(np.asarray(getattr(port_in_jax, f)),
                                      mine[f], err_msg=f)
        np.testing.assert_array_equal(ts.state_to_numpy(jax_in_port)[f],
                                      np.asarray(getattr(jax_own, f)),
                                      err_msg=f)
    assert int(port_own.step) == int(jax_own.step) > 100
    # edges: each package's own bootstrap value (an odd step count), ulps
    # apart
    assert_state_close(port_own, jax_own, rtol=1e-4, atol=5e-7,
                       exact_edges=False)

