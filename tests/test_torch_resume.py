"""resume= on the port's driver: a run split by checkpoint and resume
equals the unbroken run, a checkpoint of either package resumes in the
other, and the state lands on the run's device.

The port runs with device=cpu on impl=torch and on impl=stream (its
runner's plain version; a resumed run continues at the checkpoint's step
parity).  The split runs equal the unbroken ones bit for bit in the state
and byte for byte in the strobe and frame files; across packages the f64
runs agree at rtol 1e-12 with atol 1e-15.  The unbroken runs are made
once per module and shared.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.runtime.loop import Simulation as JSimulation

from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.runtime import loop as tloop
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import COMMON, d4_values

CPU = torch.device("cpu")
ENGINES = ["torch", "stream"]
D4 = dict(display=4, n_harmonics=8, g_grid=24, omega=10.0, t_start=0.5)
# display 9 over 101 periods of T ~0.0157 (~1,600 steps)
D9 = dict(display=9, n_harmonics=8, g_grid=24, omega=400.0, t_start=0.02)
T9 = float(np.float32(2 * np.pi / 400))


def _port(d, impl, cut=None, **kw):
    """Run the port in d; cut: t_max of a first part (as
    tests/test_runtime.py:102-138 splits a run).  Returns the
    Simulation."""
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = Simulation(SimConfig(out_file="out.txt", impl=impl,
                                   **{**COMMON, **kw}), device=CPU)
        if cut is not None:
            sim.t_max = cut
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
    finally:
        os.chdir(cwd)
    return sim


def _files(d, prefix):
    return sorted(f for f in os.listdir(d) if f.startswith(prefix))


def _state_bytes(state):
    return {k: v.tobytes() for k, v in ts.state_to_numpy(state).items()}


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """unbroken(impl, display, dtype): (directory, Simulation) of the
    unbroken D4 or D9 run, once per module; impl "jax" runs the JAX
    driver."""
    root = tmp_path_factory.mktemp("unbroken")
    runs = {}

    def get(impl, display, dtype):
        key = (impl, display, dtype)
        if key not in runs:
            d = str(root / "-".join(map(str, key)))
            kw = dict(D4 if display == 4 else D9, dtype=dtype)
            sim = _jax(d, **kw) if impl == "jax" else _port(d, impl, **kw)
            runs[key] = d, sim
        return runs[key]
    return get


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_display4_split_equals_unbroken(tmp_path, unbroken, impl, dtype):
    """Stopped after 301 steps (inside the averaging window, an odd step
    count: the resumed run starts at parity 1), checkpointed and resumed:
    the final state bit for bit and the display-4 line byte for byte."""
    full_dir, full = unbroken(impl, 4, dtype)
    d = str(tmp_path / "split")
    first = _port(d, impl, cut=0.3005, dtype=dtype, checkpoint="ck.npz",
                  **D4)
    assert first.steps_done == 301 < full.steps_done
    resumed = _port(d, impl, dtype=dtype, resume="ck.npz", **D4)
    assert resumed.steps_done == full.steps_done
    assert _state_bytes(resumed.state) == _state_bytes(full.state)
    with open(os.path.join(full_dir, "out.txt")) as a, \
            open(os.path.join(d, "out.txt")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("impl", ENGINES)
def test_display9_split_equals_unbroken(tmp_path, unbroken, impl):
    """Stopped ~40% through the 101 periods: the strobe files byte for
    byte (the accumulated strobe_values, last_rem and the frame count
    ride the checkpoint) and the final state bit for bit."""
    full_dir, full = unbroken(impl, 9, "f64")
    names = _files(full_dir, "strobe")
    assert len(names) == 101
    d = str(tmp_path / "split")
    cut = float(np.float32(D9["t_start"] + 40 * T9))
    _port(d, impl, cut=cut, dtype="f64", checkpoint="ck.npz", **D9)
    with np.load(os.path.join(d, "ck.npz")) as ck:
        n_first = len(_files(d, "strobe"))
        assert 30 < n_first < 60
        assert int(ck["extra_frame_number"]) == n_first + 1
        assert ck["extra_strobe_values"].shape == (629, D9["g_grid"] + 1)
        assert "extra_last_rem" in ck.files
    resumed = _port(d, impl, dtype="f64", resume="ck.npz", **D9)
    assert _files(d, "strobe") == names
    for name in names:
        with open(os.path.join(full_dir, name), "rb") as a, \
                open(os.path.join(d, name), "rb") as b:
            assert a.read() == b.read(), name
    assert _state_bytes(resumed.state) == _state_bytes(full.state)


def test_display7_resume_continues_the_frame_numbers(tmp_path):
    """A movie resumed from a checkpoint numbers its frames on from where
    the first part stopped, and the files equal the unbroken run's."""
    kw = dict(display=7, n_harmonics=8, g_grid=24, omega=10.0, t_start=0.2,
              dtype="f64")
    _port(str(tmp_path / "full"), "stream", **kw)
    names = _files(str(tmp_path / "full"), "frame")
    d = str(tmp_path / "split")
    first = _port(d, "stream", cut=0.4, checkpoint="ck.npz", **kw)
    assert first.frame_number == len(_files(d, "frame")) + 1 > 30
    _port(d, "stream", resume="ck.npz", **kw)
    assert _files(d, "frame") == names
    for name in names:
        with open(tmp_path / "full" / name, "rb") as a, \
                open(os.path.join(d, name), "rb") as b:
            assert a.read() == b.read(), name


def _jax(d, cut=None, **kw):
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = JSimulation(JConfig(out_file="out.txt", impl="xla",
                                  **{**COMMON, **kw}))
        if cut is not None:
            sim.t_max = cut
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
    finally:
        os.chdir(cwd)
    return sim


def _strobe(path):
    """(`# t=` lines, every number of the rows) of a strobe file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    rows = [l for l in lines if l and not l.startswith("#")]
    return ([l for l in lines if l.startswith("# t=")],
            np.array(" ".join(rows).split(), float))


def _same_strobes(d1, d2):
    names = _files(d1, "strobe")
    assert names == _files(d2, "strobe") and len(names) == 101
    for name in names:
        (ta, a), (tb, b) = (_strobe(os.path.join(d, name))
                            for d in (d1, d2))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15,
                                   err_msg=name)
        assert ta == tb, name


@pytest.mark.parametrize("first", ["jax", "port"])
def test_display9_checkpoint_crosses_packages(tmp_path, unbroken, first):
    """A display-9 checkpoint of one package resumes in the other: the
    strobe files of the split run equal the JAX package's unbroken run at
    rtol 1e-12 with atol 1e-15, `# t=` footers byte for byte."""
    ref = unbroken("jax", 9, "f64")[0]
    d = str(tmp_path / "split")
    cut = float(np.float32(D9["t_start"] + 40 * T9))
    if first == "jax":
        _jax(d, cut=cut, dtype="f64", checkpoint="ck.npz", **D9)
        _port(d, "torch", dtype="f64", resume="ck.npz", **D9)
    else:
        _port(d, "torch", cut=cut, dtype="f64", checkpoint="ck.npz", **D9)
        _jax(d, dtype="f64", resume="ck.npz", **D9)
    _same_strobes(ref, d)


def test_resumed_state_lands_on_the_run_device(tmp_path, monkeypatch):
    """Simulation passes its own device to load_state (the CPU here), so
    the resumed run never steps a state left elsewhere; the carries come
    back from the file."""
    d = str(tmp_path)
    _port(d, "torch", cut=0.3, dtype="f64", checkpoint="ck.npz", **D4)
    seen = []
    load = tloop.load_state

    def spy(path, model, device="cpu"):
        seen.append(device)
        return load(path, model, device=device)

    monkeypatch.setattr(tloop, "load_state", spy)
    monkeypatch.chdir(tmp_path)
    sim = Simulation(SimConfig(out_file="o.txt", impl="stream",
                               resume="ck.npz", dtype="f64",
                               **{**COMMON, **D4}), device=CPU)
    assert seen == [sim.device] == [CPU]
    for f in ts.FIELDS:
        assert getattr(sim.state, f).device == CPU
    with np.load("ck.npz") as ck:
        assert sim.t0 == float(ck["extra_t0"])
        assert sim.steps_done == int(ck["state_step"]) > 0


def test_display4_resume_across_packages_f64(tmp_path):
    """A JAX display-4 checkpoint resumes on the port and the port's line
    equals the JAX package's own resumed run at rtol 1e-12."""
    d = str(tmp_path / "jax")
    _jax(d, cut=0.3, dtype="f64", checkpoint="ck.npz", **D4)
    _jax(d, dtype="f64", resume="ck.npz", **{**D4})
    ref = d4_values(open(os.path.join(d, "out.txt")).read())
    p = str(tmp_path / "port")
    os.makedirs(p)
    import shutil
    shutil.copy(os.path.join(d, "ck.npz"), p)
    _port(p, "stream", dtype="f64", resume="ck.npz", **D4)
    mine = d4_values(open(os.path.join(p, "out.txt")).read())
    assert len(ref) == len(mine) == 1
    np.testing.assert_allclose(mine[0], ref[0], rtol=1e-12, atol=1e-15)
