"""The port's chunk runner (ops/stepper_cuda.py) against the JAX package's
Pallas runner.

On the CPU the port's Runner runs the kernel's plain version
(stencil.full_step over the rows of the packed xs table) and the JAX
runner runs its Pallas kernel in interpret mode, as tests/test_pallas.py
runs it.  Tolerance: rtol=1e-4, atol=1e-7 in f32, tests/test_pallas.py's
interpreter-vs-scan envelope (the JAX kernel uses the reciprocal form,
the plain version the exact division; ulp-level differences compounded
over 160 steps).  The hs-edge carries are exact copies: bit for bit.

The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.ops.stepper_pallas import make_pallas_runner
from slb2d_tpu.runtime import schedule as jsched

from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel as TModel
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import stepper_cuda

CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.1, g_grid=64, dt=1e-3, quiet=True)

TOL = dict(rtol=1e-4, atol=1e-7)
CPU = torch.device("cpu")


def build():
    jm = JModel(JConfig(**CFG, dtype="f32"))
    tm = TModel(TConfig(**CFG, dtype="f32"))
    return jm, js.consts_from_model(jm), tm, ts.consts_from_model(tm, CPU)


def to_port(jstate):
    return ts.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, CPU)


def assert_close(tstate, jstate):
    got = ts.state_to_numpy(tstate)
    for f in ("a", "b", "a_hs", "b_hs", "av"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jstate, f)),
                                   err_msg=f, **TOL)
    for f in ("hs_edge_a", "hs_edge_b"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got["t"], np.asarray(jstate.t))
    assert int(got["step"]) == int(jstate.step)


@pytest.mark.parametrize("exact", [True, False])
def test_cpu_runner_matches_pallas_interpret(exact):
    jm, jc, tm, tc = build()
    j0 = js.bootstrap_state(jc, jm)
    jr = make_pallas_runner(jc, jm, av_enabled=True, exact_trig=exact)
    tr = stepper_cuda.make_cuda_runner(tc, tm, av_enabled=True,
                                       exact_trig=exact)
    tstate = to_port(j0)
    jstate = j0
    for n in (100, 60):      # second chunk: parity/t continuation
        jstate = jr(jstate, n)
        tstate = tr(tstate, n)
        assert_close(tstate, jstate)
    assert tr.step0 == jr.step0 == 160 and tr.t0 == jr.t0
    assert tr.launches == 0          # the CPU path launches nothing
    assert _build._LOADED is None    # ...and builds nothing


def test_cpu_runner_records_match_take_obs():
    jm, jc, tm, tc = build()
    chunks = list(jsched.iter_chunks(
        omega=jm.omega, dt=jm.dt, t0=0.0, t_max=0.2, t_start=0.05,
        E_omega=jm.E_omega, display=4, frame_start=0.0, T=jm.T,
        dtype=jm.np_dtype, chunk_max=120))
    assert len(chunks) >= 2
    emits = [(3, 17, 64, 119), (0, 41)]
    jr = make_pallas_runner(jc, jm)
    tr = stepper_cuda.make_cuda_runner(tc, tm)
    jstate = js.bootstrap_state(jc, jm)
    tstate = to_port(jstate)
    steps = 0
    for chunk, emit in zip(chunks, emits):
        jstate = jr.run_xs(jstate, chunk.xs, steps % 2, emit_idx=emit)
        tstate = tr.run_xs(tstate, chunk.xs, steps % 2, emit_idx=emit)
        steps += chunk.n_steps
        jobs, tobs = jr.take_obs(len(emit)), tr.take_obs(len(emit))
        assert tobs.shape == jobs.shape == (len(emit), 13)
        np.testing.assert_array_equal(tobs[:, 4], jobs[:, 4])   # loop t
        np.testing.assert_allclose(tobs, jobs, **TOL)
        assert_close(tstate, jstate)


def test_plain_version_rejects_wrong_parity():
    jm, jc, tm, tc = build()
    state = ts.bootstrap_state(tc, tm)
    host = stepper_cuda.make_cuda_runner(tc, tm).host
    xs = stepper_cuda.build_xs_table(tm, host, 0.0, 0, 4, av_enabled=True,
                                     exact=True)
    with pytest.raises(ValueError, match="parity"):
        stepper_cuda.run_chunk_plain(tc, state, xs, 1)


def test_stepper_imports_and_builds_lazily(monkeypatch, tmp_path):
    """Importing the stepper and running it on the CPU needs no nvcc; the
    build happens at the first CUDA launch, and without nvcc it raises."""
    assert _build._LOADED is None
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load()
    assert _build._LOADED is None
    assert _build.library_path().startswith(str(tmp_path))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_runner_refuses_other_devices():
    jm, jc, tm, tc = build()
    tr = stepper_cuda.make_cuda_runner(tc, tm)
    state = ts.bootstrap_state(tc, tm)
    meta = state.replace(a=state.a.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tr(meta, 4)
