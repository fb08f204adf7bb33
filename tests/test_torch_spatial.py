"""The sharded plain scan (slb2d_tpu_torch/parallel/spatial.py: impl=torch
with shards>1) against the JAX package's (slb2d_tpu/parallel/spatial.py
make_sharded_step_runner) on the 8-device CPU mesh, and against the port's
own unsharded scan.

Inputs: the bootstrap state plus numpy noise from a seed, the same arrays
into both packages.  Tolerances: against JAX f64 rtol 1e-12 (the order of
the sums), f32 tests/test_parallel.py's sharded envelope (rtol 1e-3,
atol 1e-5: XLA fuses the sharded and unsharded bodies differently, the
docs/DEVIATIONS.md D7 class); against the port's unsharded scan the
state arrays and edges bit for bit (the halo shift is torch.roll of the
whole grid), av and the records at 1e-12 f64 (the slot-order sum)."""

import io

import numpy as np
import pytest
import torch

import jax

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.parallel import make_mesh as jax_mesh
from slb2d_tpu.parallel.spatial import make_sharded_step_runner as jax_runner
from slb2d_tpu.parallel.spatial import shard_state
from slb2d_tpu.runtime.loop import Simulation as JSimulation
from slb2d_tpu.runtime.schedule import iter_chunks

from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.parallel.mesh import make_mesh
from slb2d_tpu_torch.parallel.spatial import Slots, SpaceLayout
from slb2d_tpu_torch.runtime.loop import Simulation

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.02, g_grid=253, dt=1e-3, quiet=True)
CPU = torch.device("cpu")
N_STEPS = 40
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=1e-3,
                                                        atol=1e-5)}


def layout(S, MP):
    return SpaceLayout(make_mesh((S,), ("space",), devices=[CPU] * S), MP)


def inputs(dtype, seed=0):
    """(JAX model, port model and consts, host state dict, xs): the
    bootstrap state with seeded noise of 1e-3 of its scale on a, b, a_hs,
    b_hs, and N_STEPS steps of the host schedule."""
    jm = JModel(JConfig(**CFG, dtype=dtype))
    tm = SuperlatticeModel(SimConfig(**CFG, dtype=dtype))
    st = {k: np.asarray(v) for k, v in js.bootstrap_state(
        js.consts_from_model(jm), jm)._asdict().items()}
    rng = np.random.default_rng(seed)
    scale = np.abs(st["a"]).max()
    for k in ("a", "b", "a_hs", "b_hs"):
        st[k] = (st[k] + 1e-3 * scale * rng.standard_normal(st[k].shape)
                 ).astype(st[k].dtype)
    chunk = next(iter_chunks(
        omega=jm.omega, dt=jm.dt, t0=0.0, t_max=1.0, t_start=CFG["t_start"],
        E_omega=jm.E_omega, display=4, frame_start=0.0, T=jm.T,
        dtype=jm.np_dtype, chunk_max=N_STEPS))
    return jm, tm, ts.consts_from_model(tm, CPU), st, chunk.xs


def port_sharded(tm, c, st, xs, S):
    """The driver's sharded plain scan: stencil.run_chunk on each slot's
    slice with the layout's halo shift and slot-order sum."""
    lay = layout(S, tm.MP)
    out, ys = ts.run_chunk(lay.scatter_consts(c),
                           lay.scatter_state(ts.state_from_numpy(st, CPU)),
                           xs, collect_obs=True, shift=lay.shift,
                           sum_m=lay.sum_m)
    return lay.gather_state(out), ys.items[0]


@pytest.mark.parametrize("n_shards,dtype", [(2, "f32"), (4, "f32"),
                                            (2, "f64"), (4, "f64"),
                                            (8, "f64")])
def test_sharded_scan_matches_jax(n_shards, dtype):
    jm, tm, c, st, xs = inputs(dtype)
    mesh = jax_mesh((n_shards,), ("space",))
    run = jax_runner(js.consts_from_model(jm), jm, mesh, av_enabled=True,
                     exact_trig=True, collect_obs=True)
    jst, jys = run(shard_state(js.State(**st), mesh),
                   {k: np.asarray(v) for k, v in xs.items()})
    got, ys = port_sharded(tm, c, st, xs, n_shards)
    for f in ts.FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(jst, f)), err_msg=f,
                                   **TOL[dtype])
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **TOL[dtype])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sharded_scan_matches_unsharded_bit_for_bit(n_shards, dtype):
    _, tm, c, st, xs = inputs(dtype, seed=1)
    ref, rys = ts.run_chunk(c, ts.state_from_numpy(st, CPU), xs,
                            collect_obs=True)
    got, ys = port_sharded(tm, c, st, xs, n_shards)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "t",
              "step"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    # f32: the sums' order, a few ulp of the largest term
    tol = TOL["f64"] if dtype == "f64" else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.av.numpy(), ref.av.numpy(), **tol)
    np.testing.assert_allclose(ys.numpy(), rys.numpy(), **tol)


def test_slots_apply_slot_by_slot():
    x = Slots([torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])])
    y = (2 * x + 1) / x - x[..., :1]
    for v, got in zip(x.items, y.items):
        assert torch.equal(got, (2 * v + 1) / v - v[..., :1])
    w = torch.where(x > 1.5, x, x.new_zeros(()))
    assert [v.tolist() for v in w.items] == [[0.0, 2.0], [3.0, 4.0]]
    lo, hi = x.unbind(-1)
    assert isinstance(lo, Slots) and lo.items[1].item() == 3.0
    s = torch.stack([x, x], dim=0)
    assert s.shape == (2, 2) and x.dtype == torch.float32
    lay = layout(2, 4)
    full = torch.arange(8.0).reshape(2, 4)
    sh = lay.scatter(full)
    assert torch.equal(lay.gather(sh), full)
    for dn, dm in ((0, 1), (0, -1), (1, 1), (-1, -1), (1, 0)):
        assert torch.equal(lay.gather(lay.shift(sh, dn, dm)),
                           ts._shift(full, dn, dm))
    tot = lay.sum_m(sh)
    assert [v.tolist() for v in tot.items] == [[6.0, 22.0]] * 2


def jax_lines(tmp_path, monkeypatch, name, **kw):
    monkeypatch.chdir(tmp_path)
    JSimulation(JConfig(**{**CFG, **kw}, out_file=name)).run(
        repl_stream=io.StringIO("E_dc 1.5 0.05\nexit\n"))
    return [np.array(l.split(), float) for l in open(tmp_path / name)
            if l.strip() and not l.startswith("#")]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_driver_impl_torch_shards_matches_jax(tmp_path, monkeypatch,
                                              n_shards):
    """Simulation with shards= on impl=torch, display 4 with one REPL
    mutation and checkpoint=, against the JAX driver's shards=2 XLA run
    (f64, 1e-12) and the port's unsharded run (the checkpointed state bit
    for bit)."""
    kw = dict(dtype="f64", omega=30.0)
    ref = jax_lines(tmp_path, monkeypatch, "jax.txt", shards=2, **kw)
    mesh = make_mesh((n_shards,), ("space",), devices=[CPU] * n_shards)
    sim = Simulation(SimConfig(**{**CFG, **kw}, impl="torch",
                               shards=n_shards,
                               out_file="port.txt", checkpoint="sh.npz"),
                     mesh=mesh)
    assert sim.engine_tag() == f"torch shards={n_shards}"
    sim.run(repl_stream=io.StringIO("E_dc 1.5 0.05\nexit\n"))
    Simulation(SimConfig(**{**CFG, **kw}, impl="torch", out_file="one.txt",
                         checkpoint="one.npz"), device=CPU).run(
        repl_stream=io.StringIO("E_dc 1.5 0.05\nexit\n"))
    got = [np.array(l.split(), float) for l in open(tmp_path / "port.txt")
           if l.strip() and not l.startswith("#")]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-15)
    a, b = np.load(tmp_path / "sh.npz"), np.load(tmp_path / "one.npz")
    for k in ("state_a", "state_b", "state_a_hs", "state_b_hs",
              "state_hs_edge_a", "state_hs_edge_b", "state_step"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_shards_on_cpu_devices(tmp_path, monkeypatch, capsys):
    """The CLI never repeats a device: on the CPU (one device) shards=2
    prints an error and returns 1.  Given two local devices (two CPU
    slots stand in for two cards here, as the JAX tests' virtual CPU
    devices do) it runs shards=2 to the unsharded run's line."""
    from slb2d_tpu_torch import cli
    from slb2d_tpu_torch.parallel import mesh as tmesh
    monkeypatch.chdir(tmp_path)
    argv = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=30.0", "mu=1.0",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.02", "g-grid=253", "dt=1e-3", "dtype=f64",
            "impl=torch", "device=cpu", "quiet=1"]
    assert cli.main(argv + ["shards=2", "o=sh.txt"]) == 1
    assert "needs 2 devices, have 1" in capsys.readouterr().err
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda cfg=None, device=None: [CPU] * 2)
    assert cli.main(argv + ["shards=2", "o=sh.txt"]) == 0
    assert cli.main(argv + ["o=one.txt"]) == 0
    sh = _lines_of(tmp_path / "sh.txt")
    one = _lines_of(tmp_path / "one.txt")
    assert len(sh) == len(one) == 1
    np.testing.assert_allclose(sh[0], one[0], rtol=1e-12, atol=1e-15)


def _lines_of(path):
    return [np.array(l.split(), float) for l in open(path)
            if l.strip() and not l.startswith("#")]


SMALL = dict(CFG, omega=30.0, g_grid=125, t_start=0.05)


def _run_dir(d, mesh=None, warmup=False, cut=None, **kw):
    """Simulation in directory d (cut: the t_max of a first part, as
    tests/test_torch_resume.py splits a run); returns (d, the whole final
    state, steps done)."""
    import contextlib
    import os
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = Simulation(SimConfig(**{**SMALL, **kw}, out_file="out.txt"),
                         device=CPU, mesh=mesh)
        if cut is not None:
            sim.t_max = cut
        if warmup:
            sim.warmup()
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
    finally:
        os.chdir(cwd)
    st = sim.state if sim.layout is None else sim.layout.gather_state(
        sim.state)
    return d, st, sim.steps_done


def _files(d):
    import os
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))
            if f.endswith((".data", ".txt"))}


def _mesh(S):
    return None if S == 1 else make_mesh((S,), ("space",),
                                         devices=[CPU] * S)


@pytest.mark.parametrize("impl,dtype", [("torch", "f64"), ("stream", "f32")])
@pytest.mark.parametrize("display,extra", [
    (3, {}), (8, {}), (4, dict(warmup=True)), (4, dict(exact_time=False)),
    (77, dict(warmup=True))])
def test_sharded_displays_match_unsharded(tmp_path, impl, dtype, display,
                                          extra):
    """Displays 3 and 8, warmup=1 and exact-time=0 on both sharded
    engines (2 slots) against the unsharded run of the same engine: the
    state bit for bit; the files byte for byte where they print no sums
    (displays 3 and 8 reconstruct the gathered state), else within the
    order of the sums (f64 1e-12; f32 B2's TOL)."""
    import os
    extra = dict(extra)
    warm = extra.pop("warmup", False)
    kw = dict(display=display, impl=impl, dtype=dtype, **extra)
    d2, s2, _ = _run_dir(str(tmp_path / "two"), _mesh(2), warmup=warm,
                         shards=2, **kw)
    d1, s1, _ = _run_dir(str(tmp_path / "one"), warmup=warm, **kw)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "step"):
        assert torch.equal(getattr(s2, f), getattr(s1, f)), f
    f2, f1 = _files(d2), _files(d1)
    assert f2.keys() == f1.keys()
    if display in (3, 8):
        assert f2 == f1
        return
    tol = TOL["f64"] if dtype == "f64" else dict(rtol=1e-4, atol=5e-7)
    for name in f1:
        a = _lines_of(os.path.join(d2, name))
        b = _lines_of(os.path.join(d1, name))
        assert len(a) == len(b) >= 1
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **tol)


@pytest.mark.parametrize("first,then", [(1, 2), (2, 1), (2, 4)])
def test_checkpoint_resumes_across_layouts(tmp_path, first, then):
    """A sharded run's checkpoint resumes unsharded and the other way
    round: stopped after an odd step count (the resumed run starts at
    parity 1), checkpointed on `first` slots and resumed on `then`, the
    final state equals the unbroken unsharded run's bit for bit."""
    kw = dict(display=4, impl="torch", dtype="f64")
    _, whole, n = _run_dir(str(tmp_path / "whole"), **kw)
    d = str(tmp_path / "split")
    _, _, n1 = _run_dir(d, _mesh(first), cut=0.1005, shards=first,
                        checkpoint="ck.npz", **kw)
    assert n1 % 2 == 1 and n1 < n
    _, st, n2 = _run_dir(d, _mesh(then), shards=then, resume="ck.npz", **kw)
    assert n2 == n
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "step",
              "t"):
        assert torch.equal(getattr(st, f), getattr(whole, f)), f
