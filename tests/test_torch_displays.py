"""Displays 3, 7, 8 and 9 of the port's driver against the JAX driver, the
reference C solver's recorded output and the C transcription oracle.

The port runs with device=cpu on impl=torch (the plain tensor path) and on
impl=stream (the stream kernel's runner, its plain version on the CPU:
chunks cut at every frame and strobe event, parity carried across them).
Tolerances: f64 against the JAX Simulation (impl=xla) rtol 1e-12 with
atol 1e-15, coordinates, `# t=` headers and file names byte for byte; the
goldens at tests/test_golden.py's tolerances (display 3 f64 rtol 1e-8 atol
1e-14, norm 1e-9; f32 rtol 2e-4 atol 5e-6, norm 2e-5; display 7 f64 rtol
1e-8 atol 1e-14, f32 rtol 2e-4 atol 3e-6); displays 8 and 9 against the
transcription at tests/test_display89_oracle.py's (rtol 2e-4, atol 5e-6).
Each port run is made once per module and shared by the tests that read
it.
"""

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.runtime.loop import Simulation as JSimulation

from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.runtime.loop import Simulation

from oracle.c_transcription import CTranscription
from tests.test_display89_oracle import ATOL as ORACLE_ATOL
from tests.test_display89_oracle import RTOL as ORACLE_RTOL
from tests.test_display89_oracle import read_frame
from tests.test_golden import COMMON, read_gold

CPU = torch.device("cpu")
ENGINES = ["torch", "stream"]
RTOL, ATOL = 1e-12, 1e-15

# tests/test_golden.py's tiny shapes: display 3 at t-max=0.5, display 7 at
# t-max=0.2 (82 frames), omega=10
TINY = dict(omega=10.0, n_harmonics=8, g_grid=24)
# display 9 over its whole 101 periods in ~1,600 steps
STROBE = dict(omega=400.0, n_harmonics=8, g_grid=24, t_start=0.02)
# the per-display configurations the shared runs take
SHAPES = {3: dict(TINY, t_start=0.5), 7: dict(TINY, t_start=0.2),
          8: dict(TINY, t_start=0.3), 9: STROBE}


def _files(d, prefix):
    return sorted(f for f in os.listdir(d) if f.startswith(prefix))


def run_port(d, impl="torch", **kw):
    """Run the port in directory d (created); returns d."""
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cfg = SimConfig(out_file="out.txt", impl=impl, **{**COMMON, **kw})
        with contextlib.redirect_stdout(io.StringIO()):
            Simulation(cfg, device=CPU).run()
    finally:
        os.chdir(cwd)
    return d


def run_jax(d, **kw):
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cfg = JConfig(out_file="out.txt", impl="xla", **{**COMMON, **kw})
        with contextlib.redirect_stdout(io.StringIO()):
            JSimulation(cfg).run()
    finally:
        os.chdir(cwd)
    return d


@functools.lru_cache(maxsize=None)
def parse(path):
    """(comment lines, coordinate tokens, values) of a frame, strobe or
    display-3 file: each row's first two tokens as text, the rest as
    floats (cached: the JAX runs' files are read once per module)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    comments = [l for l in lines if l.startswith("#")]
    rows = [l for l in lines if l and not l.startswith("#")]
    tok = np.array(" ".join(rows).split()).reshape(len(rows), -1)
    return comments, tok[:, :2], tok[:, 2:].astype(float)


def assert_same_file(mine, ref, rtol=RTOL, atol=ATOL, norm_rtol=RTOL):
    mc, mx, mv = parse(mine)
    rc, rx, rv = parse(ref)
    assert np.array_equal(mx, rx), f"{mine}: coordinates differ"
    assert mv.shape == rv.shape and mv.size > 0
    np.testing.assert_allclose(mv, rv, rtol=rtol, atol=atol, err_msg=mine)
    assert len(mc) == len(rc)
    for m, r in zip(mc, rc):
        if m.startswith("# norm="):
            assert r.startswith("# norm=")
            np.testing.assert_allclose(float(m[7:]), float(r[7:]),
                                       rtol=norm_rtol)
        else:
            assert m == r          # `# t=` headers byte for byte


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX driver's f64 runs of each display, once per module."""
    root = tmp_path_factory.mktemp("jax")
    return {d: run_jax(str(root / f"d{d}"), display=d, dtype="f64", **kw)
            for d, kw in SHAPES.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """port(impl, display, dtype, **kw): the directory of the port's run
    of SHAPES[display] (with kw), made once per module."""
    root = tmp_path_factory.mktemp("port")
    runs = {}

    def get(impl, display, dtype, **kw):
        key = (impl, display, dtype, tuple(sorted(kw.items())))
        if key not in runs:
            runs[key] = run_port(str(root / str(len(runs))), impl,
                                 display=display, dtype=dtype,
                                 **{**SHAPES[display], **kw})
        return runs[key]
    return get


@pytest.mark.parametrize("impl", ENGINES)
def test_display3_matches_jax_f64(jax_runs, port, impl):
    d = port(impl, 3, "f64")
    assert_same_file(os.path.join(d, "out.txt"),
                     os.path.join(jax_runs[3], "out.txt"))


@pytest.mark.parametrize("impl", ENGINES)
def test_display8_matches_jax_f64(jax_runs, port, impl):
    d = port(impl, 8, "f64")
    assert _files(d, "frame") == ["frame.data"]
    assert_same_file(os.path.join(d, "frame.data"),
                     os.path.join(jax_runs[8], "frame.data"))


@pytest.mark.parametrize("impl", ENGINES)
def test_display7_matches_jax_f64(jax_runs, port, impl):
    d = port(impl, 7, "f64")
    names = _files(d, "frame")
    assert names == _files(jax_runs[7], "frame") and len(names) > 80
    for name in names:
        assert_same_file(os.path.join(d, name),
                         os.path.join(jax_runs[7], name))


@pytest.mark.parametrize("impl", ENGINES)
def test_display9_matches_jax_f64(jax_runs, port, impl):
    d = port(impl, 9, "f64")
    names = _files(d, "strobe")
    assert names == _files(jax_runs[9], "strobe") and len(names) == 101
    for name in names:
        assert_same_file(os.path.join(d, name),
                         os.path.join(jax_runs[9], name))


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_display3_vs_reference(port, impl, dtype):
    """d3_tiny_{f32,f64}.txt.gz at tests/test_golden.py's tolerances."""
    tol = dict(f64=(1e-8, 1e-14, 1e-9), f32=(2e-4, 5e-6, 2e-5))[dtype]
    gold = read_gold(f"d3_tiny_{dtype}.txt.gz").splitlines()
    d = port(impl, 3, dtype)
    with open(os.path.join(d, "out.txt")) as fh:
        mine = fh.read().splitlines()
    assert len(gold) == len(mine)
    for g, m in zip(gold, mine):
        if g.startswith("# norm="):
            assert m.startswith("# norm=")
            np.testing.assert_allclose(float(m[7:]), float(g[7:]),
                                       rtol=tol[2])
            continue
        gp, mp = g.split(), m.split()
        assert gp[:2] == mp[:2]
        np.testing.assert_allclose([float(mp[2]), float(mp[3])],
                                   [float(gp[2]), float(gp[3])],
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("dtype,frames,rtol,atol", [
    ("f64", (1, 2), 1e-8, 1e-14),
    ("f32", (1, 12), 2e-4, 3e-6),
])
def test_display7_frames_vs_reference(port, impl, dtype, frames, rtol, atol):
    """d7_frame{1,2}_f64 and d7_frame{1,12}_f32: the in-bounds rows
    (m=1..M+1) of each block; the reference also emits OOB rows (D3)."""
    M = TINY["g_grid"]
    d = port(impl, 7, dtype)
    for idx in frames:
        gold = [l for l in read_gold(f"d7_frame{idx}_{dtype}.txt.gz")
                .splitlines() if not l.startswith("#")]
        with open(os.path.join(d, f"frame{idx:08d}.data")) as fh:
            mine = [l for l in fh.read().splitlines()
                    if not l.startswith("#")]
        n_gold, n_mine = 2 * M + 1, M + 1
        n_blocks = len(gold) // n_gold
        assert len(gold) % n_gold == 0 and len(mine) == n_blocks * n_mine
        for blk in range(n_blocks):
            gblk = gold[blk * n_gold: blk * n_gold + n_mine]
            mblk = mine[blk * n_mine: (blk + 1) * n_mine]
            for g, m in zip(gblk, mblk):
                gp, mp = g.split(), m.split()
                assert gp[:2] == mp[:2]
                np.testing.assert_allclose(float(mp[2]), float(gp[2]),
                                           rtol=rtol, atol=atol)


def _oracle(**kw):
    return CTranscription(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
                          alpha=0.9495, N=8, PhiYmin=-10, PhiYmax=10, B=0.1,
                          M=24, **kw)


@pytest.fixture(scope="module")
def oracle8():
    """(the transcription, its display-8 (t_exit, F)), once per module."""
    o = _oracle(t_start=0.3, dt=1e-3)
    return o, o.run_display8()


@pytest.fixture(scope="module")
def oracle9():
    """(the transcription, its 4-period strobes), once per module."""
    o = _oracle(t_start=0.05, dt=2e-3)
    return o, o.run_display9(n_periods=4)


@pytest.mark.parametrize("impl", ENGINES)
def test_display8_matches_transcription(port, oracle8, impl):
    """frame.data against the transcribed GPU driver
    (tests/test_display89_oracle.py:42-66): the exact f32 t, every value,
    the coordinates byte for byte."""
    d = port(impl, 8, "f32")
    rows, _, t_hdr = read_frame(os.path.join(d, "frame.data"))
    o, (t_exit, F) = oracle8
    assert t_hdr == float(t_exit)
    M1 = o.M + 1
    assert len(rows) == F.shape[0] * M1
    mine = np.array([r[2] for r in rows], float).reshape(F.shape[0], M1)
    np.testing.assert_allclose(mine, F.astype(float), rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL)
    pxs = o.frame_phi_x()
    assert rows[0][0] == f"{float(np.float64(pxs[0])):.5f}"
    assert rows[M1][0] == f"{float(np.float64(pxs[1])):.5f}"
    assert rows[0][1] == f"{float(np.float64(o.phi_y(1))):.5f}"


@pytest.mark.parametrize("impl", ENGINES)
def test_display9_matches_transcription(tmp_path, oracle9, impl):
    """Strobe cadence and the clamp-then-accumulate values over 4 periods
    against the transcription (tests/test_display89_oracle.py:67-94)."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(display=9, n_harmonics=8, g_grid=24, t_start=0.05,
                        dtype="f32", impl=impl, frame_batch=1,
                        out_file="out.txt",
                        **{**COMMON, "dt": 2e-3, "omega": 10.0})
        sim = Simulation(cfg, device=CPU)
        o, frames_o = oracle9
        sim.t_max = float(np.float32(np.float32(0.05)
                                     + np.float32(4 * o.T)))
        sim.run()
    finally:
        os.chdir(cwd)
    files = _files(str(tmp_path), "strobe")
    assert len(files) == len(frames_o) == 4
    M1 = o.M + 1
    for name, (t_emit, strobe) in zip(files, frames_o):
        rows, _, t_hdr = read_frame(os.path.join(tmp_path, name))
        assert t_hdr == float(t_emit)
        mine = np.array([r[2] for r in rows], float).reshape(-1, M1)
        np.testing.assert_allclose(mine, strobe.astype(float),
                                   rtol=ORACLE_RTOL, atol=ORACLE_ATOL)


@pytest.mark.parametrize("display", [7, 9])
def test_frame_batch_1_equals_8(port, display):
    """frame-batch=1 (a write per emission) and frame-batch=8 (the
    default) write the same files, byte for byte, on the stream engine."""
    dirs = [port("stream", display, "f32", frame_batch=1),
            port("stream", display, "f32")]
    prefix = "frame" if display == 7 else "strobe"
    names = _files(dirs[0], prefix)
    assert names == _files(dirs[1], prefix) and len(names) > 80
    for name in names:
        with open(os.path.join(dirs[0], name), "rb") as a, \
                open(os.path.join(dirs[1], name), "rb") as b:
            assert a.read() == b.read(), name


def test_display7_lines_and_no_progress_meter(tmp_path, monkeypatch,
                                              capsys):
    """Unless quiet, display 7 prints a "Writing frame" line per frame and
    no progress meter (D13); display 8 prints "Writing frame frame.data"
    and the meter."""
    monkeypatch.chdir(tmp_path)
    base = {**COMMON, **TINY, "quiet": False, "dtype": "f64",
            "impl": "torch", "omega": 50.0}
    Simulation(SimConfig(display=7, t_start=0.2, out_file="o7.txt",
                         **base), device=CPU).run()
    out = capsys.readouterr().out
    assert "\rt=" not in out
    assert out.count("Writing frame frame") == len(_files(".", "frame")) > 25
    assert "\nWriting frame frame00000001.data\n" in out
    Simulation(SimConfig(display=8, t_start=0.2, out_file="o8.txt",
                         **base), device=CPU).run()
    out = capsys.readouterr().out
    assert "\nWriting frame frame.data\n" in out and "\rt=" in out


@pytest.mark.parametrize("display", [3, 7, 8, 9])
def test_warmup_leaves_the_frames_unchanged(tmp_path, port, display):
    """warmup() (which also runs one reconstruction for the frame
    displays) changes no output: the files equal the shared run's."""
    ref = port("stream", display, "f64")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(SimConfig(display=display, dtype="f64",
                                   impl="stream", out_file="out.txt",
                                   **{**COMMON, **SHAPES[display]}),
                         device=CPU)
        with contextlib.redirect_stdout(io.StringIO()):
            sim.warmup()
            sim.run()
    finally:
        os.chdir(cwd)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(ref)) and "out.txt" in names
    # out.txt, plus frame.data or the frame and strobe files
    assert len(names) >= {3: 1, 8: 2, 7: 3, 9: 3}[display]
    for name in names:
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("display", [7, 9])
def test_io_queue_is_bounded(tmp_path, monkeypatch, port, display):
    """With the IO thread slower than the frames (each file write held up
    by 5 ms), at most loop.IO_PENDING_MAX batches wait for it, the loop
    records the time it waited (its io.wait spans), and the files equal
    the shared frame-batch=1 run's byte for byte."""
    import time
    from slb2d_tpu_torch import tracing
    from slb2d_tpu_torch.io import writers
    from slb2d_tpu_torch.runtime import loop
    name = "write_frame" if display == 7 else "write_strobe"
    slow_write = getattr(writers, name)

    def slow(*a, **k):
        time.sleep(0.005)
        return slow_write(*a, **k)

    monkeypatch.setattr(writers, name, slow)
    pending = []
    submit = Simulation._io_submit

    def counting(self, fn):
        submit(self, fn)
        pending.append(len(self._io_futures))

    monkeypatch.setattr(Simulation, "_io_submit", counting)
    ref = port("stream", display, "f32", frame_batch=1)
    monkeypatch.chdir(tmp_path)
    sim = Simulation(SimConfig(display=display, dtype="f32", impl="stream",
                               frame_batch=1, out_file="out.txt",
                               **{**COMMON, **SHAPES[display]}), device=CPU)
    with contextlib.redirect_stdout(io.StringIO()), tracing.recording():
        sim.run()
    waited = sum(s.end_ns - s.start_ns for s in tracing.spans()
                 if s.name == "io.wait" and s.run == sim.run_id)
    prefix = "frame" if display == 7 else "strobe"
    names = _files(".", prefix)
    assert len(pending) == len(names) > 80
    assert max(pending) == loop.IO_PENDING_MAX and waited > 0
    assert names == _files(ref, prefix)
    for name in names:
        with open(name, "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
