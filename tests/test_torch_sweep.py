"""The port's parameter sweeps (parallel/sweep.py, ops/sweep_stack_cuda.py,
sweep_cli.py) against the JAX package's.

Both packages get the same grid and, where a state is handed over, the
same numpy arrays.  JAX runs as tests/test_sweep_stack.py runs it on the
CPU: impl=xla (the vmapped engine) or impl=pallas (the stacked kernel in
interpret mode).  Tolerances:
  * f64, the batched engine against the vmapped engine: rtol 1e-12 (the
    two differ in reduction order and XLA's multiply-add contraction
    only); atol 1e-14 on state arrays for entries that cancel to ~1e-17
    beside an exact 0.
  * f32, the stack runner's plain version against the JAX stacked kernel:
    both run the reciprocal form over the same exact tables, but XLA
    contracts multiply-adds into FMAs on the CPU and the port does not,
    so the two part by an ulp per step from the bootstrap on (measured
    3.4e-7 abs after 60 steps, 1.4e-5 abs on the observables after 829).
    State arrays after 60 steps are held to tests/test_pallas.py's
    envelope (rtol 1e-4, atol 1e-7), observables of the whole run to
    tests/test_sweep_stack.py's stack-vs-vmapped envelope (rtol 2e-4,
    atol 2e-5), as is the kernel path against the port's batched engine
    (exact tables against device trig).
  * av counts, the dc-only point's zero averages, the edges' bit
    patterns within the port, and the CLI's header: exact.

The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import io

import jax
import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu import sweep_cli as jcli
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.sweep_stack import SweepStackRunner as JRunner
from slb2d_tpu.parallel.sweep import ParameterSweep as JSweep

from slb2d_tpu_torch import sweep_cli as tcli
from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.config import torch_device
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import sweep_stack_cuda
from slb2d_tpu_torch.parallel import sweep as tsweep
from slb2d_tpu_torch.parallel.sweep import ParameterSweep as TSweep

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.2, g_grid=24, dt=1e-3, quiet=True)

# point 2 is dc-only (egate); mu swept, so a0 varies per point
PARAMS = {"E_dc": np.linspace(0.3, 2.0, 6),
          "E_omega": np.array([2.0, 2.0, 0.0, 1.5, 2.0, 2.0]),
          "mu": np.array([1.0, 1.2, 1.0, 0.8, 1.0, 1.1])}

OBS = ("v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin",
       "v_dr_inst", "v_y_inst", "m_over_m_x_inst", "norm", "av_count")

F64 = dict(rtol=1e-12, atol=1e-14)
F32_STATE = dict(rtol=1e-4, atol=1e-7)
ENVELOPE = dict(rtol=2e-4, atol=2e-5)

CPU = torch.device("cpu")


def port_sweep(dtype, engine="torch", params=PARAMS, **kw):
    """A port sweep on the CPU; engine='cuda' drives the stack runner,
    which runs the kernel's plain version on CPU tensors."""
    sw = TSweep(TConfig(**{**CFG, **kw}, impl="torch", dtype=dtype),
                params, device=CPU)
    sw.engine = engine
    return sw


@functools.lru_cache(maxsize=None)
def port_result(dtype, engine):
    return port_sweep(dtype, engine).run()


@functools.lru_cache(maxsize=None)
def jax_result(dtype, impl):
    return JSweep(JConfig(**CFG, impl=impl, dtype=dtype), PARAMS).run()


def assert_obs_close(got, ref, tol):
    for k in OBS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(got["av_count"], np.asarray(ref["av_count"]))


# ---- 1. the batched stencil against jax.vmap of the JAX stencil -----------

def batched_inputs(seed=7):
    """Per-point consts for both packages and a random batched state."""
    sw = port_sweep("f64")
    jsw = JSweep(JConfig(**CFG, impl="xla", dtype="f64"), PARAMS)
    B, NHP, MP = sw.B, sw.base.NHP, sw.base.MP
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape) * 0.1

    state = dict(a=arr(B, NHP, MP), b=arr(B, NHP, MP),
                 a_hs=arr(B, NHP, MP), b_hs=arr(B, NHP, MP),
                 hs_edge_a=arr(B, NHP), hs_edge_b=arr(B, NHP),
                 av=arr(B, 8), t=rng.uniform(0, 1, B),
                 step=np.array([0, 1, 2, 3, 4, 5], np.int32))
    state["av"][:, 0] = 12
    trig = [rng.uniform(-1, 1, B) for _ in range(6)]
    do_av = np.array([True, False, True, True, False, True])
    return sw, jsw, state, trig, do_av


def test_batched_full_step_matches_jax_vmap():
    sw, jsw, state, trig, do_av = batched_inputs()
    jstate = js.State(**{k: jax.numpy.asarray(v) for k, v in state.items()})
    step = jax.vmap(lambda c, s, tr, d: js.full_step(c, s, tr, d),
                    in_axes=(jsw.in_axes, 0, 0, 0))
    ref = step(jsw.consts, jstate, tuple(trig), do_av)
    tr = tuple(torch.from_numpy(x).reshape(-1, 1, 1) for x in trig[:4]) \
        + tuple(torch.from_numpy(x) for x in trig[4:])
    got = ts.full_step(sw.consts, ts.state_from_numpy(state, CPU), tr,
                       torch.from_numpy(do_av))
    for f in ts.FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **F64)
    # av untouched where do_av is off; ghost fill by each point's parity
    np.testing.assert_array_equal(got.av.numpy()[~do_av],
                                  state["av"][~do_av])
    ghost = sw.models[0].a0_ghost != 0
    for p in range(sw.B):
        expect = (sw.models[p].a0_ghost[ghost] if (p + 1) % 2 == 0 else 0)
        np.testing.assert_array_equal(got.a.numpy()[p][ghost], expect)


def test_batched_tiptoe_and_half_step_match_jax_vmap():
    sw, jsw, state, trig, _ = batched_inputs(seed=3)
    cos_wdt = trig[0]
    ref = jax.vmap(js.tiptoe_half_step, in_axes=(jsw.in_axes, 0, 0))(
        jsw.consts, state["a"], cos_wdt)
    got = ts.tiptoe_half_step(sw.consts, torch.from_numpy(state["a"]),
                              torch.from_numpy(cos_wdt).reshape(-1, 1, 1))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F64)
    arrs = [state[k] for k in ("a", "b", "a_hs", "b_hs")]
    for main in (True, False):
        ref = jax.vmap(functools.partial(js.apply_half_step, main=main,
                                         use_reciprocal=True),
                       in_axes=(jsw.in_axes, 0, 0, 0, 0, 0, 0))(
            jsw.consts, *arrs, trig[0], trig[1])
        got = ts.apply_half_step(
            sw.consts, *(torch.from_numpy(x) for x in arrs),
            torch.from_numpy(trig[0]).reshape(-1, 1, 1),
            torch.from_numpy(trig[1]).reshape(-1, 1, 1), main=main,
            use_reciprocal=True)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **F64)


def test_single_run_state_has_no_point_axis():
    """The point axis is optional: a single run's shapes are unchanged."""
    sw = port_sweep("f32")
    m = sw.base
    c = ts.consts_from_model(m, CPU)
    st = ts.bootstrap_state(c, m)
    new = ts.full_step(c, st, (1.0, 0.9, 0.95, 0.85, 1.0, 0.0), True)
    assert new.a.shape == (m.NHP, m.MP) and new.av.shape == (8,)
    assert new.hs_edge_a.shape == (m.NHP,) and new.t.shape == ()
    rec = ts.emission_record(c, st, new)
    assert rec.shape == (13,)


# ---- 2. the batched engine against the vmapped engine ---------------------

def test_batched_engine_matches_jax_xla_f64():
    assert_obs_close(port_result("f64", "torch"), jax_result("f64", "xla"),
                     F64)


def test_batched_engine_initial_states_match_jax_f64():
    sw = port_sweep("f64")
    jsw = JSweep(JConfig(**CFG, impl="xla", dtype="f64"), PARAMS)
    got = ts.state_to_numpy(sw._initial_states())
    ref = jsw._initial_states()
    assert sw.n_steps == jsw.n_steps
    for f in ts.FIELDS:
        r = np.asarray(getattr(ref, f))
        assert got[f].dtype == r.dtype and got[f].shape == r.shape, f
        np.testing.assert_allclose(got[f], r, err_msg=f, **F64)


# ---- 3. the kernel path on the CPU (the kernel's plain version) -----------

def test_stack_runner_matches_jax_stack_runner_f32():
    """60 steps in two chunks (the second starts at parity 1) from one
    state, the port's runner (plain version) against the JAX runner."""
    sw = port_sweep("f32", engine="cuda")
    jsw = JSweep(JConfig(**CFG, impl="pallas", dtype="f32"), PARAMS)
    jstate = jsw._initial_states()
    tstate = ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)
    jr = JRunner(jsw, g_points=4)            # 6 points -> ragged 8
    tr = sweep_stack_cuda.SweepStackRunner(sw)
    for n in (25, 35):
        jstate = jr.advance(jstate, n)
        tstate = tr.advance(tstate, n)
        got = ts.state_to_numpy(tstate)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
            np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                       err_msg=f, **F32_STATE)
        np.testing.assert_array_equal(got["t"], np.asarray(jstate.t))
        np.testing.assert_array_equal(got["step"], np.asarray(jstate.step))
    assert tr.step0 == jr.step0 == 60 and tr.t0 == jr.t0
    np.testing.assert_array_equal(got["av"][2], 0)       # dc-only point
    assert tr.launches == 0                  # the CPU path launches nothing
    assert _build._LOADED is None            # ...and builds nothing


def test_kernel_path_matches_jax_pallas_f32():
    assert_obs_close(port_result("f32", "cuda"), jax_result("f32", "pallas"),
                     ENVELOPE)


def test_kernel_path_matches_batched_engine_f32():
    assert_obs_close(port_result("f32", "cuda"), port_result("f32", "torch"),
                     ENVELOPE)


def test_plain_version_rejects_wrong_parity():
    sw = port_sweep("f32", engine="cuda")
    tr = sweep_stack_cuda.SweepStackRunner(sw)
    with pytest.raises(ValueError, match="parity"):
        sweep_stack_cuda.run_chunk_plain(sw.consts, sw._initial_states(),
                                         tr.chunk_table(3), 1, tr.egate)


def test_chunk_tables_continue_the_schedule():
    """Tables of chunks positioned by seek (as a resumed sweep positions
    its runner) continue the one-chunk table bit for bit (t, trig and the
    time window), so chunking cannot move a step's averaging gate."""
    sw = port_sweep("f32", engine="cuda")
    tr = sweep_stack_cuda.SweepStackRunner(sw)
    one = tr.chunk_table(sw.n_steps)
    parts, done = [], 0
    for k in (300, 1, sw.n_steps - 301):
        tr.seek(done)
        parts.append(tr.chunk_table(k))
        done += k
    np.testing.assert_array_equal(np.concatenate(parts), one)
    assert one[:, 6].sum() == 629       # the period window's steps


# ---- 4. the dc-only point -------------------------------------------------

@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_dc_only_point_keeps_zero_averages(engine):
    res = port_result("f32", engine)
    for k in ("av_count", "v_dr_av", "v_y_av", "m_over_m_x_av", "A",
              "Asin"):
        assert res[k][2] == 0, k
    assert np.all(res["av_count"][[0, 1, 3, 4, 5]] > 0)
    assert np.all(np.isfinite(res["norm"]))


# ---- 5. routing and devices ---------------------------------------------

OMEGA = {"omega": [9.0, 10.0]}


@pytest.mark.parametrize("impl,dtype,params,device,engine", [
    ("auto", "f32", PARAMS, "cuda:0", "cuda"),
    ("auto", "f32", OMEGA, "cuda:0", "cuda"),    # omega: the kernel
    ("auto", "f64", PARAMS, "cuda:0", "torch"),
    ("auto", "f32", PARAMS, "cpu", "torch"),
    ("cuda", "f32", PARAMS, "cuda:0", "cuda"),
    ("cuda", "f64", PARAMS, "cuda:0", "cuda"),
    ("torch", "f32", PARAMS, "cuda:0", "torch"),
    ("auto", "f64", OMEGA, "cuda:0", "torch"),
    ("cuda", "f32", OMEGA, "cuda:0", "cuda"),    # per-omega kernel
    ("cuda", "f64", OMEGA, "cuda:0", "cuda"),
    ("torch", "f32", OMEGA, "cuda:0", "torch"),
])
def test_engine_choice(impl, dtype, params, device, engine):
    """Frames (capture_state) take no part: either engine captures them."""
    cfg = TConfig(**CFG, impl=impl, dtype=dtype)
    assert tsweep.choose_engine(cfg, torch.device(device)) == engine


def test_impl_cuda_never_falls_back():
    """impl=cuda takes omega sweeps, with or without frames, to the
    per-omega kernel and never to the batched engine: a CPU device
    raises."""
    cfg = TConfig(**CFG, impl="cuda")
    omega = {"omega": np.array([9.0, 10.0])}
    for params in (PARAMS, omega):
        for frames in (False, True):
            with pytest.raises(ValueError, match="CUDA device"):
                TSweep(cfg, params, device=CPU, capture_state=frames)
    assert sweep_stack_cuda.SweepStackRunner(
        port_sweep("f32", engine="cuda", params=omega)).per_omega


def test_unported_sweep_options_raise(capsys):
    """What a sweep refuses: a dt axis; shards=2 without a mesh whose
    space axis holds 2 slots; and in the CLI a shard count that does not
    divide the devices (one CPU here), with JAX's message."""
    with pytest.raises(ValueError, match="cannot sweep"):
        TSweep(TConfig(**CFG, impl="torch"), {"dt": [1e-3]}, device=CPU)
    with pytest.raises(ValueError, match="space_axis"):
        TSweep(TConfig(**CFG, impl="torch", shards=2), PARAMS, device=CPU)
    assert tcli.main(cli_argv("f64", "stderr")
                     + ["shards=2", "device=cpu"]) == 1
    assert ("shards=2 does not divide the 1 available devices."
            in capsys.readouterr().err)


def test_sweeps_run_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """device= picks cuda:<n> for every impl; only device=cpu runs on the
    CPU; without a card the CLI returns 1 naming device=cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for impl in ("torch", "auto", "cuda"):
        assert tcli.main(cli_argv("f64", tmp_path / "x.txt")
                         + [f"impl={impl}"]) == 1
        assert "device=cpu" in capsys.readouterr().err
        with pytest.raises(RuntimeError, match="cuda:1"):
            TSweep(TConfig(**CFG, impl=impl, device=1), PARAMS)
    sw = TSweep(TConfig(**CFG, impl="torch", device="cpu"), PARAMS)
    assert sw.device == CPU and sw.engine == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for impl in ("torch", "auto", "cuda"):
        assert torch_device(TConfig(**CFG, impl=impl, device=2)) == \
            torch.device("cuda:2")
        with pytest.raises(RuntimeError, match="invalid device ordinal"):
            torch_device(TConfig(**CFG, impl=impl, device=3))
        assert tcli.main(cli_argv("f64", tmp_path / "x.txt")
                         + [f"impl={impl}", "device=3"]) == 1
        assert "invalid device ordinal" in capsys.readouterr().err


# ---- 6. checkpoints -------------------------------------------------------

class Stop(Exception):
    pass


def stop_after_first_save(sweep_cls, monkeypatch):
    orig = sweep_cls._save_checkpoint

    def save_once(self, path, states, cap, done):
        orig(self, path, states, cap, done)
        if done < self.n_steps:
            raise Stop

    monkeypatch.setattr(sweep_cls, "_save_checkpoint", save_once)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, engine):
    dtype = "f64" if engine == "torch" else "f32"
    ck = str(tmp_path / "ck.npz")
    with monkeypatch.context() as mp:
        stop_after_first_save(TSweep, mp)
        with pytest.raises(Stop):
            port_sweep(dtype, engine).run(checkpoint=ck,
                                          checkpoint_every=300)
    res = port_sweep(dtype, engine).run(resume=ck)
    full = port_result(dtype, engine)
    for k in OBS:       # the same steps in the same order: bit for bit
        np.testing.assert_array_equal(res[k], full[k], err_msg=k)


def test_checkpoints_load_across_packages(tmp_path, monkeypatch):
    ck_port = str(tmp_path / "port.npz")
    ck_jax = str(tmp_path / "jax.npz")
    with monkeypatch.context() as mp:
        stop_after_first_save(TSweep, mp)
        stop_after_first_save(JSweep, mp)
        with pytest.raises(Stop):
            port_sweep("f64").run(checkpoint=ck_port, checkpoint_every=300)
        with pytest.raises(Stop):
            JSweep(JConfig(**CFG, impl="xla", dtype="f64"),
                   PARAMS).run(checkpoint=ck_jax, checkpoint_every=300)
    with np.load(ck_port) as zp, np.load(ck_jax) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and \
                zp[k].shape == zj[k].shape, k
    jres = JSweep(JConfig(**CFG, impl="xla", dtype="f64"),
                  PARAMS).run(resume=ck_port)
    assert_obs_close(jres, jax_result("f64", "xla"), F64)
    tres = port_sweep("f64").run(resume=ck_jax)
    assert_obs_close(tres, port_result("f64", "torch"), F64)


def test_checkpoint_of_another_grid_is_refused(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck.npz")
    with monkeypatch.context() as mp:
        stop_after_first_save(TSweep, mp)
        with pytest.raises(Stop):
            port_sweep("f64").run(checkpoint=ck, checkpoint_every=300)
    other = dict(PARAMS, E_dc=np.linspace(0.3, 2.5, 6))
    with pytest.raises(ValueError, match="different grid"):
        port_sweep("f64", params=other).run(resume=ck)
    with pytest.raises(ValueError, match="dtype"):
        port_sweep("f32").run(resume=ck)


# ---- 7. the CLI -----------------------------------------------------------

def cli_argv(dtype, out):
    return ["E_dc=1.0", "E_omega=2.0", "omega=10.0", "mu=1.0",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.2", "g-grid=24", "dt=1e-3", "quiet=1",
            f"dtype={dtype}", f"o={out}",
            "sweep:E_dc=0.3,2.0,3", "sweep:E_omega=2;0"]


def table(text):
    lines = text.splitlines()
    return ([l for l in lines if l.startswith("#")],
            np.array([l.split() for l in lines if not l.startswith("#")],
                     float))


def test_cli_matches_jax_cli_f64(tmp_path):
    assert tcli.main(cli_argv("f64", tmp_path / "p.txt")
                     + ["impl=torch", "device=cpu"]) == 0
    assert jcli.main(cli_argv("f64", tmp_path / "j.txt") + ["impl=xla"]) == 0
    ph, pv = table((tmp_path / "p.txt").read_text())
    jh, jv = table((tmp_path / "j.txt").read_text())
    assert ph == jh == [tcli.HEADER.strip()]
    assert tcli.HEADER == jcli.HEADER
    assert pv.shape == jv.shape == (6, 15)
    np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=1e-15)


def test_cli_refinement_session_matches_jax(tmp_path, monkeypatch):
    """Two grids from one read-from=stdin session: a rejected line, then a
    refinement with a scalar override, then exit."""
    session = ("sweep:E_dc=1;2 dt=oops\n"
               "sweep:E_dc=0.5;0.7 B=0.2\n"
               "exit\n")
    outs = {}
    for name, mod, impl in (("p", tcli, "torch"), ("j", jcli, "xla")):
        monkeypatch.setattr("sys.stdin", io.StringIO(session))
        out = tmp_path / f"{name}.txt"
        argv = cli_argv("f64", out)[:-2] + ["sweep:E_dc=0.3;0.4",
                                             "read-from=stdin",
                                             f"impl={impl}"]
        if mod is tcli:
            argv.append("device=cpu")
        assert mod.main(argv) == 0
        outs[name] = (tmp_path / f"{name}.txt").read_text()
    ph, pv = table(outs["p"])
    jh, jv = table(outs["j"])
    assert ph == jh and len(ph) == 2        # one header per grid
    assert pv.shape == jv.shape == (4, 15)
    np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=1e-15)
    assert np.all(pv[2:, 5] == 0.2)         # the B override took


def test_cli_rejects_bad_specs():
    assert tcli.main(["sweep:E_dc=1,2"]) == 1
    assert tcli.main(["E_dc=1"]) == 1


def test_sweep_consts_vary_exactly_the_jax_fields():
    sw = port_sweep("f64")
    jsw = JSweep(JConfig(**CFG, impl="xla", dtype="f64"), PARAMS)
    axes = jsw.in_axes._asdict()
    for f in dataclasses.fields(ts.StencilConsts):
        got = getattr(sw.consts, f.name)
        ref = np.asarray(getattr(jsw.consts, f.name))
        # per-point fields carry the point axis: (B, 1, 1) or (B, NHP, MP)
        assert (got.dim() == 3) == (axes[f.name] == 0), f.name
        np.testing.assert_array_equal(got.numpy().reshape(ref.shape), ref,
                                      err_msg=f.name)
