"""The lane-packed sweep kernel's runner (ops/sweep_lanes_cuda.py) on the
CPU, where it runs the kernel's plain version, against the JAX package's
lane-packed Pallas runner in interpret mode (as tests/test_sweep_pallas.py
runs it) and against the vmapped and batched sweep engines.

Tolerances:
  * f32 against JAX run_sweep_pallas: tests/test_sweep_pallas.py's rtol
    2e-4, atol 1e-7 on av, the captures and every packed state segment.
    The two run the same per-step math over the same packed layout, but
    XLA contracts multiply-adds into FMAs on the CPU and the port does not
    (measured: 1.2e-6 abs on the state, 6.9e-7 on the norm capture after
    335 steps).  v_y, a sum that cancels to ~1e-3 of its terms' scale,
    gets atol 3e-7: against an f64 run of the same sweep the float32 v_y
    capture is off by up to 2.5e-7 in the JAX kernel and 2.0e-7 in the
    port (measured on these grids), who are also held to that f64 run at
    these tolerances;
  * f64 plain version against JAX's vmapped engine (_run_sweep): rtol
    1e-10 (per-lane means and Kahan sums summed per segment differ from
    the per-point recurrences of the sums by rounding only; the vmapped
    engine divides where the kernel multiplies by a reciprocal), atol
    1e-14 for entries that cancel beside an exact 0;
  * the port's batched engine against the plain version through
    ParameterSweep.run()'s observables: f64 rtol 1e-10, f32
    tests/test_sweep_stack.py's envelope, rtol 2e-4, atol 2e-5;
  * av counts, the dc-only point's zero averages, and chunked launches
    against one launch: exact.

The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.
"""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.ops.sweep_pallas import run_sweep_pallas
from slb2d_tpu.parallel.sweep import ParameterSweep as JSweep

from slb2d_tpu_torch import tracing
from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
from slb2d_tpu_torch.parallel.sweep import ParameterSweep as TSweep

CPU = torch.device("cpu")

# tests/test_sweep_pallas.py's config
CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=20.0, mu=1.0,
           alpha=0.9495, n_harmonics=6, phi_y_min=-5.0, phi_y_max=5.0,
           B=0.1, t_start=0.02, g_grid=29, dt=1e-3, quiet=True)

GRIDS = {
    # tests/test_sweep_pallas.py:41-42: an E_dc sweep and one dc-only point
    "pallas": {"E_dc": np.linspace(0.5, 2.0, 3),
               "E_omega": np.asarray([2.0, 2.0, 0.0])},
    # omega swept: each point's own window end and loop exit, one dc-only
    "omega": {"omega": np.asarray([16.0, 20.0, 25.0, 32.0]),
              "E_dc": np.asarray([0.4, 0.9, 1.4, 1.9]),
              "E_omega": np.asarray([2.0, 2.0, 0.0, 1.5])},
    # mu swept: a0 differs per point
    "mu": {"mu": np.asarray([0.8, 1.0, 1.2]),
           "E_dc": np.asarray([0.5, 1.0, 1.5])},
}

F32 = dict(rtol=2e-4, atol=1e-7)
VY = dict(rtol=2e-4, atol=3e-7)
F64 = dict(rtol=1e-10, atol=1e-14)
ENVELOPE = dict(rtol=2e-4, atol=2e-5)
OBS = ("v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin", "v_dr_inst",
       "v_y_inst", "m_over_m_x_inst", "norm")


def port_sweep(grid, dtype="f32"):
    return TSweep(TConfig(**CFG, impl="torch", dtype=dtype), GRIDS[grid],
                  device=CPU)


@functools.lru_cache(maxsize=None)
def port_lanes(grid, max_points=16):
    return slc.run_sweep_lanes(port_sweep(grid), max_points=max_points)


@functools.lru_cache(maxsize=None)
def jax_lanes(grid):
    return run_sweep_pallas(JSweep(JConfig(**CFG, dtype="f32"), GRIDS[grid]))


def _xla_reference(sw):
    """JAX's vmapped engine over the whole sweep (tests/test_sweep_pallas.py
    _xla_reference): (states, cap)."""
    from slb2d_tpu.parallel.sweep import _run_sweep
    D = sw.base.np_dtype
    cap0 = {k: jax.numpy.zeros((sw.B,), D)
            for k in ("v_dr", "v_y", "m_x", "norm")}
    weights = {k: jax.numpy.asarray(getattr(sw.base, k))
               for k in ("w_d4", "w_d4_phi", "w_norm")}
    return _run_sweep(sw.consts, sw._initial_states(), cap0, weights,
                      in_axes=sw.in_axes, n_steps=sw.n_steps, unroll=1)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_lanes_match_jax_lanes_f32(grid):
    av, cap, state = port_lanes(grid)
    jav, jcap, jstate = jax_lanes(grid)
    np.testing.assert_array_equal(av[:, 0], jav[:, 0])          # counts
    for j in range(8):
        np.testing.assert_allclose(av[:, j], jav[:, j], err_msg=f"av[{j}]",
                                   **(VY if j == 2 else F32))
    for k in slc.CAP_KEYS:
        np.testing.assert_allclose(cap[k], jcap[k], err_msg=k,
                                   **(VY if k == "v_y" else F32))
    MP = port_sweep(grid).base.MP
    for f, got, ref in zip(("a", "b", "a_hs", "b_hs"), state, jstate):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (ref.shape[0],
                                          len(av) * MP), f
        for b in range(len(av)):
            seg = slice(b * MP, (b + 1) * MP)
            np.testing.assert_allclose(got[:, seg], ref[:, seg],
                                       err_msg=f"{f} point {b}", **F32)
    dc_only = GRIDS[grid].get("E_omega", np.ones(len(av))) == 0
    assert np.all(av[dc_only] == 0)
    assert np.all(av[~dc_only, 0] > 0)
    if grid == "pallas":
        assert av[2, 0] == 0
    if grid == "omega":            # per-point windows: distinct counts
        assert len(np.unique(av[~dc_only, 0])) == 3


@pytest.mark.parametrize("grid", ["pallas", "omega"])
def test_chunked_launches_match_one_launch(grid):
    """max_points=2: chunks of two points, the last padded with a copy
    whose window never opens; bit for bit with one chunk, as no step
    reduces across lanes."""
    av1, cap1, st1 = port_lanes(grid)
    av2, cap2, st2 = port_lanes(grid, max_points=2)
    np.testing.assert_array_equal(av2, av1)
    for k in cap1:
        np.testing.assert_array_equal(cap2[k], cap1[k])
    for x1, x2 in zip(st1, st2):
        np.testing.assert_array_equal(x2, x1)


@functools.lru_cache(maxsize=None)
def _plain_f64(grid):
    """The plain version in f64 over one chunk of the whole grid (the
    runner itself is float32-only, as the JAX kernel)."""
    sw = port_sweep(grid, "f64")
    pack = slc.pack_chunk(sw, range(sw.B), sw.B, sw._initial_states())
    st = slc.run_lanes_plain(pack, pack.state0.clone(), sw.n_steps)
    av, cap, state = slc.finish_chunk(pack, st)
    return sw, av, dict(zip(slc.CAP_KEYS, cap)), state


@pytest.mark.parametrize("grid", ["omega", "mu"])
def test_plain_f64_matches_jax_vmapped_engine(grid):
    sw, av, cap, state = _plain_f64(grid)
    assert av.dtype == np.float64
    ref_states, ref_cap = _xla_reference(
        JSweep(JConfig(**CFG, dtype="f64"), GRIDS[grid]))
    ref_av = np.asarray(ref_states.av)
    np.testing.assert_array_equal(av[:, 0], ref_av[:, 0])
    np.testing.assert_allclose(av[:, :6], ref_av[:, :6], **F64)
    for k in slc.CAP_KEYS:
        np.testing.assert_allclose(cap[k], np.asarray(ref_cap[k]),
                                   err_msg=k, **F64)
    MP = sw.base.MP
    for b in range(sw.B):
        np.testing.assert_allclose(state[0][:, b * MP:(b + 1) * MP],
                                   np.asarray(ref_states.a[b]),
                                   err_msg=f"point {b}", **F64)


@pytest.mark.parametrize("grid", ["omega", "mu"])
def test_plain_f32_tracks_its_f64_run(grid):
    """The f32 plain version against the same sweep in f64, at the f32
    tolerances above."""
    av, cap, state = port_lanes(grid)
    _, av64, cap64, state64 = _plain_f64(grid)
    np.testing.assert_array_equal(av[:, 0], av64[:, 0])
    for j in range(8):
        np.testing.assert_allclose(av[:, j], av64[:, j], err_msg=f"av[{j}]",
                                   **(VY if j == 2 else F32))
    for k in slc.CAP_KEYS:
        np.testing.assert_allclose(cap[k], cap64[k], err_msg=k,
                                   **(VY if k == "v_y" else F32))
    for got, ref in zip(state, state64):
        np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plain_matches_port_batched_engine(dtype):
    """ParameterSweep.run() on the batched torch engine against the plain
    version's observables (lanes.observables), over the omega grid."""
    sw = port_sweep("omega", dtype)
    ref = sw.run()
    if dtype == "f32":
        av, cap, _ = port_lanes("omega")
        tol = ENVELOPE
    else:
        _, av, cap, _ = _plain_f64("omega")
        tol = F64
    got = slc.observables(sw, av, cap)
    np.testing.assert_array_equal(got["av_count"], ref["av_count"])
    for k in OBS:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)
    assert abs(float(got["norm"][0]) - 1.0) < 1e-3


def test_split_steps_carry_parity_and_time():
    """A run split across calls at an odd step (151, then the rest) equals
    one call bit for bit: the ghost fill and edge parity and the loop t
    continue from the global step."""
    sw = port_sweep("omega")
    runner = slc.make_sweep_lanes_runner(sw)
    one = runner.advance(0, runner.start(0), sw.n_steps)
    two = runner.advance(0, runner.start(0), 151)
    two = runner.advance(0, two, sw.n_steps - 151, step0=151)
    for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
        assert torch.equal(getattr(two, f), getattr(one, f)), f
    assert runner.loop_t(151) == pytest.approx(0.151, rel=1e-5)
    assert runner.launches == 0          # the CPU ran the plain version


def test_lane_constants_match_the_kernel_source():
    """The per-point table's columns, the weight rows and each form's
    launches (the streaming form's per step, the cluster form's per call)
    are written in both csrc/sweep_lanes.cu and the runner."""
    src = open(os.path.join(os.path.dirname(slc.__file__), "..", "csrc",
                            "sweep_lanes.cu")).read()
    seg = dict(re.findall(r"(SEG_[A-Z]+) = (\d+)", src))
    assert seg and set(seg) == {n for n in dir(slc)
                                if re.fullmatch(r"SEG_[A-Z]+", n)}
    for name, v in seg.items():
        assert getattr(slc, name) == int(v), name
    rows = dict(re.findall(r"W_([A-Z0-9_]+) = (\d+)", src))
    assert {k.lower(): int(v) for k, v in rows.items()} == {
        w[2:]: i for i, w in enumerate(slc.W_ROWS)}
    assert src.count("<<<") == slc.LAUNCHES_PER_STEP
    assert src.count("cudaLaunchKernelEx(") == slc.LAUNCHES_PER_CALL
    assert "slb_lanes_chunk" in _build._ENTRY_ARGS
    assert any(s.endswith("sweep_lanes.cu") for s in _build.SOURCES)


def test_runner_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                      tmp_path):
    sw64 = port_sweep("pallas", "f64")
    with pytest.raises(ValueError, match="float32-only"):
        slc.make_sweep_lanes_runner(sw64)
    sw = port_sweep("pallas")
    with pytest.raises(ValueError, match="max_points"):
        slc.make_sweep_lanes_runner(sw, max_points=0)
    sw.device = torch.device("cuda:0")           # a card that is not there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slc.make_sweep_lanes_runner(sw)
    # no fallback: the launch path builds the kernel or raises, even for
    # tensors the plain version could take
    runner = slc.make_sweep_lanes_runner(port_sweep("pallas"))
    assert runner.CB == 3 and len(runner.packs) == 1
    st = runner.start(0)
    with pytest.raises(ValueError, match="contiguous float32"):
        runner._launch(runner.packs[0], st.__class__(
            **{**vars(st), "av": st.av.double()}), 4, 0, 0.0)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    counts = tracing.counters()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        runner._launch(runner.packs[0], st, 4, 0, 0.0)
    assert runner.launches == 0 and tracing.counters() == counts
    with pytest.raises(ValueError, match="unsupported device"):
        runner.advance(0, st.__class__(**{k: v.to("meta")
                                          for k, v in vars(st).items()}),
                       4)
