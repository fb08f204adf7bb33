"""The sharded form of B2 (slb2d_tpu_torch/parallel/stream_shard.py:
run_chunk_plain_stream_sharded, ShardedStreamRunner, Simulation with
shards>1 and impl=stream) against the JAX package's sharded stream engine
(slb2d_tpu/ops/stepper_stream.py make_sharded_stream_runner, its Pallas
kernel in interpret mode on the 8-device CPU mesh) and against the port's
unsharded tiling form.

On the CPU the runner runs the plain version: each shard's extended slice
(its L columns and H halo columns a side from its neighbours), cut into
tiles and stepped K steps a round.  Tolerances against JAX in f32: the
runner's state and av at rtol 2e-5, atol 1e-8 (the largest needs read:
rtol 1.24e-5 at atol 1e-8, a_hs; XLA's interpreter and torch round f32
apart); the driver's lines and frames at tests/test_stream.py's rtol
2e-4, atol 1e-6 (largest differences read: 7.5e-7 on display 4, 9.2e-7
on display 77, 1.0e-6 and 3.2e-6 on the display-7 and 9 frames; rtol
5e-6 at atol 1e-8, the JAX package's limit between two runs of its own
sharded engine, would need rtol 1.8e-4, 3.1e-3 and 5.8e-5).  Against the
port's unsharded tiling form the state and edges bit for bit (a tile's
centre after K steps depends only on the cells within 2K <= H columns,
however the grid is cut), av and the records at B2's TOL (the tiles'
sums added in another order).  The CUDA kernel is held against this plain
version on a card by tests/test_torch_cuda.py."""

import glob
import io
import os

import numpy as np
import pytest
import torch

import jax

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.stepper_stream import make_sharded_stream_runner
from slb2d_tpu.parallel import make_mesh as jax_mesh
from slb2d_tpu.parallel.spatial import shard_state
from slb2d_tpu.runtime.loop import Simulation as JSimulation
from slb2d_tpu.runtime.schedule import iter_chunks

from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import stepper_stream_cuda as ssc
from slb2d_tpu_torch.ops.stepper_cuda import pack_xs_dict
from slb2d_tpu_torch.parallel.mesh import make_mesh
from slb2d_tpu_torch.parallel import stream_shard as shd
from slb2d_tpu_torch.parallel.spatial import SpaceLayout
from slb2d_tpu_torch.runtime.loop import Simulation

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.05, g_grid=253, dt=1e-3, quiet=True)
CPU = torch.device("cpu")
# B2's TOL (tests/test_torch_stream.py: f32 interpreter ulp class and the
# tiles' sum order)
TOL = dict(rtol=1e-4, atol=5e-7)
# the runner against JAX's sharded runner (see the module docstring)
TOL_JAX = dict(rtol=2e-5, atol=1e-8)


def layout(S, MP):
    return SpaceLayout(make_mesh((S,), ("space",), devices=[CPU] * S), MP)


def xs_table(model, n):
    chunk = next(iter_chunks(
        omega=model.omega, dt=model.dt, t0=0.0, t_max=1.0,
        t_start=CFG["t_start"], E_omega=model.E_omega, display=4,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, chunk_max=n))
    return chunk.xs


def seeded_state(jm, seed):
    st = {k: np.asarray(v) for k, v in js.bootstrap_state(
        js.consts_from_model(jm), jm)._asdict().items()}
    rng = np.random.default_rng(seed)
    scale = np.abs(st["a"]).max()
    for k in ("a", "b", "a_hs", "b_hs"):
        st[k] = (st[k] + 1e-3 * scale * rng.standard_normal(st[k].shape)
                 ).astype(st[k].dtype)
    return st


def sharded_runs(runner, lay, st, xs, split):
    """Two run_xs calls (parity continuation); the gathered state."""
    state = lay.scatter_state(ts.state_from_numpy(st, CPU))
    first = {k: v[:split] for k, v in xs.items()}
    rest = {k: v[split:] for k, v in xs.items()}
    state = runner.run_xs(state, first, 0)
    state = runner.run_xs(state, rest, split % 2)
    return lay.gather_state(state)


def test_plain_matches_jax_sharded_stream_runner():
    """K=8 on 2 shards of MP=256 (the JAX engine's smallest: 128-column
    slices), 120 steps in two calls, from a seeded state."""
    jm = JModel(JConfig(**CFG))
    tm = SuperlatticeModel(SimConfig(**CFG))
    st = seeded_state(jm, 0)
    xs = xs_table(tm, 120)
    mesh = jax_mesh((2,), ("space",))
    jr = make_sharded_stream_runner(js.consts_from_model(jm), jm, mesh, K=8)
    jx = {k: np.asarray(v) for k, v in xs.items()}
    out = jr.run_xs(shard_state(js.State(**st), mesh),
                    {k: v[:67] for k, v in jx.items()}, 0)
    out = jr.run_xs(out, {k: v[67:] for k, v in jx.items()}, 1)
    lay = layout(2, tm.MP)
    runner = shd.ShardedStreamRunner(
        lay.scatter_consts(ts.consts_from_model(tm, CPU)), tm, lay, K=8)
    assert runner.geom.K == 8 and runner.geom.H == 16
    got = sharded_runs(runner, lay, st, xs, 67)
    for f in ("a", "b", "a_hs", "b_hs", "av"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(out, f)), err_msg=f,
                                   **TOL_JAX)
    for f in ("hs_edge_a", "hs_edge_b"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(out, f)))


@pytest.mark.parametrize("g_grid,n_harmonics,S,W", [
    (253, 8, 2, None),     # MP=256, L=128: default_geometry's W
    (253, 8, 4, 20),       # L=64: 4 tiles, a ragged last one
    (100, 8, 4, 7),        # MP=128, L=32: M+1 in shard 3, in shard 2's halo
    (100, 18, 8, 5),       # L=16 = 2H, NHP=24
])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plain_matches_unsharded_tiling_bit_for_bit(g_grid, n_harmonics, S,
                                                    W, dtype):
    cfg = SimConfig(**{**CFG, "g_grid": g_grid,
                       "n_harmonics": n_harmonics}, dtype=dtype)
    tm = SuperlatticeModel(cfg)
    c = ts.consts_from_model(tm, CPU)
    st = seeded_state(JModel(JConfig(**{**CFG, "g_grid": g_grid,
                                        "n_harmonics": n_harmonics},
                                     dtype=dtype)), 2)
    xs = pack_xs_dict(xs_table(tm, 45), tm.np_dtype)
    emit = [0, 7, 22, 44]
    one = ssc.default_geometry(tm.NHP, tm.MP, 4, K=4, W=13)
    ref, robs = ssc.run_chunk_plain_stream(c, ts.state_from_numpy(st, CPU),
                                           xs, 0, emit, one)
    lay = layout(S, tm.MP)
    geom = ssc.default_geometry(tm.NHP, lay.L, 4, K=4, W=W)
    out, obs = shd.run_chunk_plain_stream_sharded(
        c, lay.scatter_state(ts.state_from_numpy(st, CPU)), xs, 0, emit,
        geom, lay)
    got = lay.gather_state(out)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "step"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    tol = TOL if dtype == "f32" else dict(rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.av.numpy(), ref.av.numpy(), **tol)
    np.testing.assert_allclose(obs.numpy(), robs.numpy(), **tol)


def test_geometry_check_raises_at_construction():
    with pytest.raises(ValueError, match="does not divide the padded grid"):
        shd.validate_shard_geometry(104, 20096, 3)
    with pytest.raises(ValueError, match="lower shards="):
        shd.validate_shard_geometry(16, 128, 16)         # L=8 < 2H=16
    shd.validate_shard_geometry(104, 20096, 4)
    shd.validate_shard_geometry(16, 128, 8)               # L = 2H
    for shards, what in ((3, "does not divide"), (32, "lower shards=")):
        with pytest.raises(ValueError, match=what):
            Simulation(SimConfig(**{**CFG, "g_grid": 100}, impl="stream",
                                 shards=shards),
                       mesh=make_mesh((shards,), ("space",),
                                      devices=[CPU] * shards))
    # the plain scan needs only MP % shards == 0
    Simulation(SimConfig(**{**CFG, "g_grid": 100}, impl="torch", shards=32),
               mesh=make_mesh((32,), ("space",), devices=[CPU] * 32))
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        Simulation(SimConfig(**CFG, impl="stream", shards=4, device="cpu"))


def _lines(path):
    return [np.array(l.split(), float) for l in open(path)
            if l.strip() and not l.startswith("#")]


def _jax_run(d, display, repl=None, **kw):
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = JSimulation(JConfig(**{**CFG, "display": display, **kw},
                                  out_file="out.txt", frame_batch=4))
        if display == 9:
            sim.t_max = float(np.float32(np.float32(CFG["t_start"])
                                         + np.float32(3 * sim.model.T)))
        sim.run(repl_stream=None if repl is None else io.StringIO(repl))
    finally:
        os.chdir(cwd)
    return d


def _port_run(d, display, repl=None, shards=2, **kw):
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        mesh = (None if shards == 1 else
                make_mesh((shards,), ("space",), devices=[CPU] * shards))
        sim = Simulation(SimConfig(**{**CFG, "display": display, **kw},
                                   out_file="out.txt", frame_batch=4,
                                   impl="stream", shards=shards),
                         device=CPU, mesh=mesh)
        if display == 9:
            sim.t_max = float(np.float32(np.float32(CFG["t_start"])
                                         + np.float32(3 * sim.model.T)))
        sim.run(repl_stream=None if repl is None else io.StringIO(repl))
    finally:
        os.chdir(cwd)
    return d, sim


REPL = {4: "E_dc 1.5 0.05\nexit\n", 77: None}


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """jax_sharded(display): the JAX driver's shards=2 impl=pallas run's
    directory (display 4 with one REPL round, display 77), once per
    module."""
    root = tmp_path_factory.mktemp("jax_sharded")
    runs = {}

    def get(display):
        if display not in runs:
            runs[display] = _jax_run(str(root / f"d{display}"), display,
                                     REPL[display], shards=2, impl="pallas",
                                     omega=30.0)
        return runs[display]
    return get


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("display", [4, 77])
def test_driver_shards2_matches_jax_sharded_pallas(tmp_path, jax_sharded,
                                                   display, shards):
    """Displays 4 (with a REPL round) and 77 through the driver with
    shards=2, 4 and 8, impl=stream, device=cpu, against the JAX driver's
    shards=2 impl=pallas run (its kernel wants 128-column slices, so 2 at
    MP=256) and the port's unsharded impl=stream run."""
    kw = dict(omega=30.0)
    jd = jax_sharded(display)
    pd, sim = _port_run(str(tmp_path / "port"), display, REPL[display],
                        shards=shards, **kw)
    assert sim.engine_tag() == f"stream sharded shards={shards}"
    ud, one = _port_run(str(tmp_path / "one"), display, REPL[display],
                        shards=1, **kw)
    ref, got, un = (_lines(os.path.join(d, "out.txt")) for d in (jd, pd, ud))
    assert len(got) == len(ref) == len(un) >= 2
    for g, r, u in zip(got, ref, un):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(g, u, **TOL)
    whole = sim.layout.gather_state(sim.state)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(whole, f), getattr(one.state, f)), f


@pytest.mark.parametrize("display,pattern", [(7, "frame*.data"),
                                             (9, "strobe*.data")])
def test_driver_shards2_frames_match_jax(tmp_path, display, pattern):
    """Displays 7 and 9 through the driver with shards=2, impl=stream,
    device=cpu, against the JAX driver's XLA run, as
    tests/test_stream.py holds its sharded engine's frames (the JAX
    sharded kernel needs 128-column slices; this grid has 64)."""
    kw = dict(omega=60.0, g_grid=125, t_start=0.05)
    jd = _jax_run(str(tmp_path / "jax"), display, shards=1, impl="xla", **kw)
    pd, _ = _port_run(str(tmp_path / "port"), display, **kw)
    ref = sorted(glob.glob(os.path.join(jd, pattern)))
    got = sorted(glob.glob(os.path.join(pd, pattern)))
    assert [os.path.basename(f) for f in got] == \
        [os.path.basename(f) for f in ref] and len(got) >= 3
    for fg, fr in zip(got, ref):
        vg = np.array([l.split()[2] for l in open(fg)
                       if not l.startswith("#")], float)
        vr = np.array([l.split()[2] for l in open(fr)
                       if not l.startswith("#")], float)
        np.testing.assert_allclose(vg, vr, rtol=2e-4, atol=1e-6,
                                   err_msg=fg)
