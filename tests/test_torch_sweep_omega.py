"""The port's omega sweeps (the sweep kernel's per-omega mode), per-point
sweep frames (frames-dir=) and absorption map against the JAX package's.

Both packages get the same grid and, where a state is handed over, the
same numpy arrays.  JAX runs as tests/test_sweep_stack.py and
tests/test_sweep_frames.py run it on the CPU: impl=pallas (the stacked
kernel in interpret mode) or impl=xla (the vmapped engine).  On the CPU
the port's per-omega runner runs the kernel's plain version.
Tolerances:
  * the per-omega runner against the JAX per-omega runner, f32, from one
    state: rtol 1e-4, atol 1e-7 (tests/test_pallas.py's envelope) on
    state arrays, av and the four loop-exit captures; t and step exact.
    The two part by XLA's multiply-add contraction, the CPU's cos/sin,
    and the main-grid mu at resync steps (csrc/sweep_stack.cu header);
  * whole omega sweeps in f32, the kernel path against JAX impl=pallas
    and impl=xla and against the port's batched engine: rtol 2e-4, atol
    2e-5 (tests/test_sweep_stack.py's stack-vs-vmapped envelope);
  * f64: the batched engine against JAX impl=xla at rtol 1e-12 (reduction
    order and XLA's contraction only), the per-omega kernel path against
    JAX impl=xla at rtol 1e-10 (chain drift of ~32 ulp, measured 2e-13);
    atol 1e-14 for entries that cancel beside an exact 0;
  * av counts, the dc-only point's zero averages, a resumed run against
    an uninterrupted one with the same chunks, the frames index and the
    frame files written from the same arrays: exact.

The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import io
import os
import re

import numpy as np
import pytest
import torch

from slb2d_tpu import sweep_cli as jcli
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.ops.sweep_stack import SweepStackRunner as JRunner
from slb2d_tpu.parallel.sweep import ParameterSweep as JSweep

from slb2d_tpu_torch import absorption_map
from slb2d_tpu_torch import sweep_cli as tcli
from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
from slb2d_tpu_torch.parallel.sweep import ParameterSweep as TSweep

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.2, g_grid=24, dt=1e-3, quiet=True)

# tests/test_sweep_stack.py's OMEGA_PARAMS: distinct periods, so distinct
# windows and exit steps; point 2 is dc-only
OMEGA_PARAMS = {"omega": np.array([8.0, 10.0, 12.0, 14.0, 10.0]),
                "E_dc": np.linspace(0.4, 1.8, 5),
                "E_omega": np.array([2.0, 2.0, 0.0, 1.5, 2.0])}

OBS = ("v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin",
       "v_dr_inst", "v_y_inst", "m_over_m_x_inst", "norm", "av_count")

F64 = dict(rtol=1e-12, atol=1e-14)
F64_CHAINS = dict(rtol=1e-10, atol=1e-14)
F32_STATE = dict(rtol=1e-4, atol=1e-7)
ENVELOPE = dict(rtol=2e-4, atol=2e-5)

CPU = torch.device("cpu")


def port_sweep(dtype, engine, params=OMEGA_PARAMS, capture_state=False,
               **kw):
    """A port sweep on the CPU; engine='cuda' drives the stack runner,
    which runs the kernel's plain version on CPU tensors."""
    sw = TSweep(TConfig(**{**CFG, **kw}, impl="torch", dtype=dtype,
                        device="cpu"), params, capture_state=capture_state)
    sw.engine = engine
    return sw


@functools.lru_cache(maxsize=None)
def port_result(dtype, engine):
    return port_sweep(dtype, engine).run()


@functools.lru_cache(maxsize=None)
def jax_result(dtype, impl):
    return JSweep(JConfig(**CFG, impl=impl, dtype=dtype), OMEGA_PARAMS).run()


def assert_obs_close(got, ref, tol):
    for k in OBS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(got["av_count"], np.asarray(ref["av_count"]))


# ---- 1. the per-omega runner (plain version) against the JAX runner -------

def test_omega_runner_matches_jax_runner_f32():
    """From one state at step 630, 25 then 40 steps: the second chunk
    re-evaluates its chains at 0 and 32 (the JAX runner's block and tail),
    and the omega=14 point's window ends and its capture fires at step
    648 inside the first chunk."""
    sw = port_sweep("f32", "cuda")
    jsw = JSweep(JConfig(**CFG, impl="pallas", dtype="f32"), OMEGA_PARAMS)
    jstate = jsw._initial_states()._replace(
        step=np.full(sw.B, 630, np.int32))
    tstate = ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)
    jr = JRunner(jsw, g_points=2)            # 5 points -> ragged 6
    tr = ssc.SweepStackRunner(sw)
    assert tr.per_omega and jr.per_omega
    jr.seek(630)
    tr.seek(630)
    jcap = {k: np.zeros(sw.B, np.float32) for k in ssc.CAP_KEYS}
    tcap = {k: torch.zeros(sw.B) for k in ssc.CAP_KEYS}
    for n in (25, 40):
        jstate, jcap = jr.advance(jstate, n, cap=jcap)
        tstate, tcap = tr.advance(tstate, n, cap=tcap)
        got = ts.state_to_numpy(tstate)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
            np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                       err_msg=f, **F32_STATE)
        for k in ssc.CAP_KEYS:
            np.testing.assert_allclose(tcap[k].numpy(), np.asarray(jcap[k]),
                                       err_msg=k, **F32_STATE)
        np.testing.assert_array_equal(got["t"], np.asarray(jstate.t))
        np.testing.assert_array_equal(got["step"], np.asarray(jstate.step))
    assert tr.step0 == jr.step0 == 695 and tr.t0 == jr.t0
    # only the omega=14 point exited (t_end = 0.2 + 2pi/14); its window
    # closed there, the others kept averaging for all 65 steps
    fired = tcap["norm"].numpy() != 0
    np.testing.assert_array_equal(fired, [False, False, False, True, False])
    np.testing.assert_array_equal(got["av"][:, 0], [65, 65, 0, 19, 65])
    assert tr.launches == 0                  # the CPU path launches nothing
    assert _build._LOADED is None            # ...and builds nothing


def test_omega_runner_threads_its_capture():
    sw = port_sweep("f32", "cuda")
    tr = ssc.SweepStackRunner(sw)
    st = sw._initial_states()
    with pytest.raises(ValueError, match="pass cap"):
        tr.advance(st, 3)
    shared = ssc.SweepStackRunner(port_sweep(
        "f32", "cuda", params={"E_dc": np.array([0.5, 1.0])}))
    assert not shared.per_omega
    with pytest.raises(ValueError, match="no cap"):
        shared.advance(st, 3, cap={})


def test_pp_lanes_match_the_kernel_source():
    """The column table's lane order, the resync period and the capture
    width are written in both csrc/sweep_stack.cu and the runner."""
    src = open(os.path.join(os.path.dirname(ssc.__file__), "..", "csrc",
                            "sweep_stack.cu")).read()
    lanes = dict(re.findall(r"(PP_[A-Z]+) = (\d+)", src))
    for name, v in lanes.items():
        assert getattr(ssc, name) == int(v), name
    assert set(lanes) == {n for n in dir(ssc)
                          if re.fullmatch(r"PP_[A-Z]+", n)}
    assert re.search(rf"TRIG_RESYNC = {ssc.TRIG_RESYNC};", src)
    assert re.search(rf"CAP_COLS = {len(ssc.CAP_KEYS)};", src)
    assert ssc.CHUNK_STEPS % ssc.TRIG_RESYNC == 0


# ---- 2. whole omega sweeps ------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_omega_kernel_path_matches_jax_f32(impl):
    res = port_result("f32", "cuda")
    assert_obs_close(res, jax_result("f32", impl), ENVELOPE)
    counts = res["av_count"]
    assert len(np.unique(counts[[0, 1, 3]])) == 3      # per-point windows
    for k in ("av_count", "v_dr_av", "v_y_av", "m_over_m_x_av", "A",
              "Asin"):
        assert res[k][2] == 0, k                       # dc-only point


def test_omega_kernel_path_matches_batched_engine_f32():
    assert_obs_close(port_result("f32", "cuda"), port_result("f32", "torch"),
                     ENVELOPE)


def test_omega_batched_engine_matches_jax_xla_f64():
    assert_obs_close(port_result("f64", "torch"), jax_result("f64", "xla"),
                     F64)


def test_omega_kernel_path_f64_matches_jax_xla():
    """The f64 per-omega form (B3 is float-only) against the vmapped f64
    engine."""
    assert_obs_close(port_result("f64", "cuda"), jax_result("f64", "xla"),
                     F64_CHAINS)


# ---- 3. checkpoints -------------------------------------------------------

class Stop(Exception):
    pass


def stop_after_first_save(sweep_cls, monkeypatch):
    orig = sweep_cls._save_checkpoint

    def save_once(self, path, states, cap, done):
        orig(self, path, states, cap, done)
        if done < self.n_steps:
            raise Stop

    monkeypatch.setattr(sweep_cls, "_save_checkpoint", save_once)


def interrupted_checkpoint(tmp_path, monkeypatch, make, cls=TSweep,
                           name="ck.npz"):
    """A checkpoint saved at step 700: past the shortest point's exit
    (649 at omega=14), before the longest (985 at omega=8)."""
    ck = str(tmp_path / name)
    with monkeypatch.context() as mp:
        stop_after_first_save(cls, mp)
        with pytest.raises(Stop):
            make().run(checkpoint=ck, checkpoint_every=700)
    return ck


@pytest.mark.parametrize("engine,dtype", [("cuda", "f32"), ("torch", "f64")])
def test_omega_resume_equals_uninterrupted(tmp_path, monkeypatch, engine,
                                           dtype):
    ck = interrupted_checkpoint(
        tmp_path, monkeypatch, lambda: port_sweep(dtype, engine))
    with np.load(ck) as z:
        assert int(z["done"]) == 700
        if engine == "cuda":   # the kernel writes a capture at its exit
            assert z["cap_norm"][3] != 0 and z["cap_norm"][0] == 0
    res = port_sweep(dtype, engine).run(resume=ck)
    # the same steps in the same chunks: bit for bit
    same = port_sweep(dtype, engine).run(
        checkpoint=str(tmp_path / "other.npz"), checkpoint_every=700)
    for k in OBS:
        np.testing.assert_array_equal(res[k], same[k], err_msg=k)
    # against one unchunked run: the kernel path's chains re-evaluate at
    # other steps after 700
    assert_obs_close(res, port_result(dtype, engine),
                     ENVELOPE if engine == "cuda" else F64)


def test_omega_checkpoints_load_across_packages(tmp_path, monkeypatch):
    ck_port = interrupted_checkpoint(
        tmp_path, monkeypatch, lambda: port_sweep("f32", "cuda"),
        name="p.npz")
    ck_jax = interrupted_checkpoint(
        tmp_path, monkeypatch,
        lambda: JSweep(JConfig(**CFG, impl="xla", dtype="f32"),
                       OMEGA_PARAMS), cls=JSweep, name="j.npz")
    with np.load(ck_port) as zp, np.load(ck_jax) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and \
                zp[k].shape == zj[k].shape, k
    jres = JSweep(JConfig(**CFG, impl="xla", dtype="f32"),
                  OMEGA_PARAMS).run(resume=ck_port)
    assert_obs_close(jres, jax_result("f32", "xla"), ENVELOPE)
    tres = port_sweep("f32", "cuda").run(resume=ck_jax)
    assert_obs_close(tres, port_result("f32", "cuda"), ENVELOPE)


# ---- 4. per-point frames --------------------------------------------------

FRAMES_CFG = dict(CFG, t_start=0.3, dtype="f64")


def test_frames_capture_freezes_each_point_at_its_own_exit():
    """tests/test_sweep_frames.py's check on the batched engine: each
    point's captured (a, b) equal a one-point sweep's, whose run ends at
    that point's exit."""
    cfg = TConfig(**FRAMES_CFG, impl="torch", device="cpu")
    omegas = np.array([8.0, 12.0])
    sw = TSweep(cfg, {"omega": omegas}, capture_state=True)
    sw.run()
    a2, b2 = sw.final_ab
    for i, om in enumerate(omegas):
        solo = TSweep(cfg, {"omega": np.array([om])}, capture_state=True)
        solo.run()
        np.testing.assert_array_equal(a2[i], solo.final_ab[0][0])
        np.testing.assert_array_equal(b2[i], solo.final_ab[1][0])
    assert sw.n_steps > TSweep(cfg, {"omega": np.array([12.0])}).n_steps


def test_frames_on_the_kernel_path_take_the_final_state():
    """With a shared omega the kernel path freezes every point at the last
    step: its (a, b) are the final state's, within the f32 envelope of
    the batched engine's rolled capture."""
    params = {"E_dc": np.array([0.5, 1.5])}
    kern = port_sweep("f32", "cuda", params=params, capture_state=True,
                      t_start=0.3)
    batched = port_sweep("f32", "torch", params=params, capture_state=True,
                         t_start=0.3)
    rk, rb = kern.run(), batched.run()
    assert_obs_close(rk, rb, ENVELOPE)
    for got, ref in zip(kern.final_ab, batched.final_ab):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-6)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_omega_frames_on_the_kernel_path(dtype):
    """With omega swept the kernel path (here its plain version) freezes
    each point's (a, b) at its own exit, as the batched engine does: f32
    within the envelope of the port's batched engine, f64 against JAX
    impl=xla's capture at the per-omega f64 tolerance."""
    params = {"omega": np.array([8.0, 12.0]), "E_dc": np.array([0.5, 1.5])}
    kern = port_sweep(dtype, "cuda", params=params, capture_state=True,
                      t_start=0.3)
    res = kern.run()
    if dtype == "f32":
        ref_sweep = port_sweep("f32", "torch", params=params,
                               capture_state=True, t_start=0.3)
        ref = ref_sweep.run()
        ref_ab, obs_tol, ab_tol = (ref_sweep.final_ab, ENVELOPE,
                                   dict(rtol=1e-4, atol=5e-6))
    else:
        jsw = JSweep(JConfig(**FRAMES_CFG, impl="xla"), params)
        ref = jsw.run(capture_state=True)
        ref_ab, obs_tol, ab_tol = jsw.final_ab, F64_CHAINS, F64_CHAINS
    assert_obs_close(res, ref, obs_tol)
    for got, want in zip(kern.final_ab, ref_ab):
        np.testing.assert_allclose(got, np.asarray(want), **ab_tol)
    # the omega=12 point froze ~240 steps before the omega=8 point's end
    assert not np.array_equal(kern.final_ab[0][1], kern.final_ab[0][0])


def frames_argv(out, frames, *grid):
    return ["E_dc=1", "E_omega=2", "omega=10", "mu=1", "alpha=0.9495",
            "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10", "B=0.1",
            "t-max=0.3", "dt=1e-3", "g-grid=24", "quiet=1", "dtype=f64",
            f"o={out}", f"frames-dir={frames}", *grid]


def split_frame(text):
    """('#' lines, the phi columns as text, the f values)."""
    lines = text.splitlines()
    body = [l.split() for l in lines if not l.startswith("#")]
    return ([l for l in lines if l.startswith("#")],
            [(x, y) for x, y, _ in body], np.array([v for *_, v in body],
                                                   float))


@pytest.mark.parametrize("grid", [
    ("sweep:E_dc=0.5;1.5",),
    ("sweep:omega=8;12", "sweep:E_dc=0.5;1.5"),
], ids=["shared-omega", "omega"])
def test_frames_cli_matches_jax_cli_f64(tmp_path, grid):
    """The same files: index.txt byte for byte; each frame's headers and
    phi columns byte for byte, its values and norm at rtol 1e-12 (the two
    engines' states differ in the last bits, and %0.20f prints them; atol
    1e-15 where f cancels to ~1e-20 from harmonics of order 0.1)."""
    assert tcli.main(frames_argv(tmp_path / "p.txt", tmp_path / "p",
                                 *grid) + ["impl=torch", "device=cpu"]) == 0
    assert jcli.main(frames_argv(tmp_path / "j.txt", tmp_path / "j",
                                 *grid) + ["impl=xla"]) == 0
    pdir, jdir = tmp_path / "p" / "grid00", tmp_path / "j" / "grid00"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert (pdir / "index.txt").read_bytes() == \
        (jdir / "index.txt").read_bytes()
    n = len((jdir / "index.txt").read_text().splitlines()) - 1
    assert n == (4 if len(grid) == 2 else 2)
    for i in range(n):
        ph, pxy, pv = split_frame((pdir / f"point{i:04d}.data").read_text())
        jh, jxy, jv = split_frame((jdir / f"point{i:04d}.data").read_text())
        assert ph[0] == jh[0] and len(ph) == len(jh) == 2
        assert pxy == jxy
        np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(float(ph[1][7:]), float(jh[1][7:]),
                                   rtol=1e-12)


def test_frames_writer_byte_for_byte_with_jax(tmp_path):
    """Given the same captured arrays and norms, the port's frames writer
    and the JAX package's write the same bytes."""
    jsw = JSweep(JConfig(**FRAMES_CFG, impl="xla"),
                 {"omega": np.array([8.0, 12.0])})
    res = jsw.run(capture_state=True)
    jcli._write_point_frames(jsw.cfg, jsw, res, str(tmp_path / "j"), 3)
    tsw = port_sweep("f64", "torch", params={"omega": np.array([8.0, 12.0])},
                     t_start=0.3)
    tsw.final_ab = tuple(np.asarray(x) for x in jsw.final_ab)
    tcli._write_point_frames(tsw.cfg, tsw, res, str(tmp_path / "p"), 3)
    for f in ("index.txt", "point0000.data", "point0001.data"):
        assert (tmp_path / "p" / "grid03" / f).read_bytes() == \
            (tmp_path / "j" / "grid03" / f).read_bytes(), f


def test_frames_with_interactive_refinement(tmp_path, monkeypatch):
    """Each refinement grid writes its own grid%02d; a rejected line does
    not take a slot."""
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "sweep:E_dc=9,9,2 shards=3\n"         # rejected: bad override key
        "sweep:E_dc=2.0;2.5\n"
        "exit\n"))
    argv = frames_argv(tmp_path / "t.txt", tmp_path / "fr",
                       "sweep:E_dc=0.5;1.5")
    assert tcli.main(argv + ["read-from=stdin", "device=cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "fr")) == ["grid00", "grid01"]
    idx = (tmp_path / "fr/grid01/index.txt").read_text().splitlines()
    assert float(idx[1].split()[1]) == 2.0


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_frames_checkpoint_resume_roundtrip(tmp_path, monkeypatch, engine):
    """The (a, b) capture rides the sweep checkpoint on either engine; a
    frames/no-frames mismatch is refused.  The resumed run equals the
    uninterrupted one bit for bit: on the kernel path one with the same
    chunks (its chains re-evaluate at each chunk's start)."""
    def make():
        return port_sweep("f64", engine, params={"omega": np.array(
            [8.0, 12.0])}, capture_state=True, t_start=0.3)

    full = make()
    every = 900      # between the exits at steps 824 and 1085
    if engine == "cuda":
        full.run(checkpoint=str(tmp_path / "other.npz"),
                 checkpoint_every=every)
    else:
        full.run()
    ck = str(tmp_path / "ck.npz")
    with monkeypatch.context() as mp:
        stop_after_first_save(TSweep, mp)
        with pytest.raises(Stop):
            make().run(checkpoint=ck, checkpoint_every=every)
    with np.load(ck) as z:
        assert {"cap_a", "cap_b"} <= set(z.files)
        # the omega=12 point exited before the save; the kernel writes the
        # omega=8 point's only at its exit, the batched engine every step
        assert np.any(z["cap_a"][1] != 0)
        assert np.any(z["cap_a"][0] != 0) == (engine == "torch")
    resumed = make()
    resumed.run(resume=ck)
    for got, ref in zip(resumed.final_ab, full.final_ab):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="capture keys"):
        port_sweep("f64", "torch", params={"omega": np.array([8.0, 12.0])},
                   t_start=0.3).run(resume=ck)


# ---- 5. the absorption map ------------------------------------------------

def test_absorption_map_tables_match_jax(monkeypatch, capsys):
    """The port's absorption_map on a 2 x 3 grid at N=8, M=24 on the CPU
    (device=cpu) prints the JAX vmapped sweep's A and <v_dr> tables."""
    e_dc, omega = np.array([0.5, 1.5]), np.array([8.0, 10.0, 12.0])
    kw = dict(CFG, E_omega=1.5, impl="auto")
    monkeypatch.setattr(absorption_map, "grid",
                        lambda paper: (dict(kw), e_dc, omega))
    assert absorption_map.main(["device=cpu"]) == 0
    out = capsys.readouterr()
    assert "[torch engine]" in out.err
    rows = [np.array(l.split(), float) for l in out.out.splitlines()
            if not l.startswith("#")]
    assert len(rows) == 4 and all(r.shape == (3,) for r in rows)
    E, W = np.meshgrid(e_dc, omega, indexing="ij")
    ref = JSweep(JConfig(**{**kw, "impl": "xla"}),
                 {"E_dc": E.ravel(), "omega": W.ravel()}).run()
    np.testing.assert_allclose(np.concatenate(rows[:2]), ref["A"],
                               **ENVELOPE)
    np.testing.assert_allclose(np.concatenate(rows[2:]), ref["v_dr_av"],
                               **ENVELOPE)


def test_absorption_map_grids_are_the_examples():
    kw, e_dc, omega = absorption_map.grid(True)
    assert (kw["n_harmonics"], kw["g_grid"], kw["t_start"], kw["E_omega"],
            kw["impl"]) == (40, 500, 5.0, 1.5, "cuda")
    np.testing.assert_array_equal(e_dc, np.linspace(0, 3, 16))
    np.testing.assert_array_equal(omega, np.linspace(6, 14, 16))
    kw, e_dc, omega = absorption_map.grid(False)
    assert (kw["n_harmonics"], kw["g_grid"], e_dc.size, omega.size) == \
        (12, 64, 7, 5)


def test_absorption_map_without_a_card_needs_device_cpu(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert absorption_map.main([]) == 1
    assert "device=cpu" in capsys.readouterr().err
