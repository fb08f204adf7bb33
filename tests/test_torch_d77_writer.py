"""The display-77 writer of the port, which formats a chunk's records in one
pass (io/writers.write_display77_from_record), against the JAX package's
per-record writer (slb2d_tpu.io.writers.write_display77_from_record) on
the same records: byte for byte, in f32 and f64, quiet or not, into a
StringIO, a real file or stdout, through io/d77fmt.cpp's formatter and
through the Python fallback.  Records come from a tiny impl=torch display-77
run, plus edge rows: zeros of either sign, subnormals, |x| >= 1e15,
infinities, NaN of either sign, t at rounding ties and t = 0."""

import functools
import io
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.io import writers as jwriters
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel

from slb2d_tpu_torch import tracing
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.io import native, writers
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import COMMON

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(COMMON, display=77, n_harmonics=8, g_grid=24, t_start=0.2,
            omega=10.0)
DTYPES = ("f32", "f64")


@functools.lru_cache(maxsize=None)
def run_records(dtype):
    """The records a tiny impl=torch display-77 run hands its writer, one
    array a chunk."""
    got = []
    real = writers.write_display77_from_record

    def keep(out, model, rec, **kw):
        got.append(np.array(rec, copy=True))
        return real(out, model, rec, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(writers, "write_display77_from_record", keep)
        Simulation(SimConfig(**TINY, dtype=dtype, out_file="/dev/null",
                             impl="torch"),
                   device=torch.device("cpu")).run()
    return got


def edge_records(dtype):
    """Rows of the record layout that the physics never gives but a
    diverging or hand-fed run can: every column's edge values."""
    D = np.float32 if dtype == "f32" else np.float64
    tiny = float(np.finfo(D).smallest_subnormal)
    nan = float("nan")
    vals = [0.0, -0.0, tiny, -tiny, 3 * tiny, 1e15, -2.5e16, 3e20, 1e30,
            1e300, -1.7e308,
            float("inf"), float("-inf"), nan, float(np.copysign(nan, -1.0)),
            0.5, 1e-21, 2 ** -21, 3 * 2 ** -21, 0.1]
    ts = [2 ** -21, 3 * 2 ** -21, 5 * 2 ** -22, 1023 * 2 ** -21, 0.25, 0.0,
          -0.0, 1.5, 7.0 + 2 ** -21, nan]
    rows = []
    for i, v in enumerate(vals):
        for j, t in enumerate(ts):
            rec = np.full(13, vals[(i + j) % len(vals)], np.float64)
            rec[i % 11] = v
            rec[4] = t
            rows.append(rec)
    return np.asarray(rows).astype(D)


def models(dtype):
    kw = {k: v for k, v in TINY.items() if k != "quiet"}
    return (JModel(JConfig(**kw, dtype=dtype)),
            SuperlatticeModel(SimConfig(**kw, dtype=dtype)))


@pytest.fixture(scope="module")
def built_lib(tmp_path_factory):
    """A copy of io/'s formatter source with the library built in it."""
    root = tmp_path_factory.mktemp("d77fmt")
    for f in ("Makefile", "d77fmt.cpp"):
        shutil.copy(os.path.join(ROOT, "slb2d_tpu_torch", "io", f), root)
    assert os.system(f"make -s -C {root} libd77fmt.so") == 0
    return str(root)


@pytest.fixture(params=["native", "python"])
def formatter(request, monkeypatch, built_lib):
    """The port's display-77 writer through the native formatter, loaded
    from the built copy, or through the Python fallback."""
    if request.param == "native":
        monkeypatch.setattr(native, "_d77_dir", lambda: built_lib)
        monkeypatch.setattr(native, "_D77", None)
        monkeypatch.setattr(native, "_D77_TRIED", False)
        assert native.format_d77_rows(np.zeros((1, 15)), "",
                                      echo=False, lines=True) is not None
    else:
        monkeypatch.setattr(native, "format_d77_rows",
                            lambda *a, **kw: None)
    return request.param


def _sink(kind, tmp_path, name):
    if kind == "stringio":
        return io.StringIO()
    if kind == "file":
        return open(tmp_path / name, "w")
    return sys.stdout


def _text(kind, out, tmp_path, name):
    if kind == "stringio":
        return out.getvalue()
    if kind == "file":
        out.close()
        return (tmp_path / name).read_text()
    return ""


@pytest.mark.parametrize("sink", ["stringio", "file", "stdout"])
@pytest.mark.parametrize("quiet", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_same_bytes_as_the_per_record_writer(dtype, quiet, sink, formatter,
                                             tmp_path, capsys):
    chunks = run_records(dtype) + [edge_records(dtype)]
    assert sum(map(len, chunks)) > 50
    jm, tm = models(dtype)
    capsys.readouterr()

    ref = _sink(sink, tmp_path, "ref.txt")
    ref_norms = [jwriters.write_display77_from_record(ref, jm, rec,
                                                      quiet=quiet)
                 for recs in chunks for rec in recs]
    ref_text = _text(sink, ref, tmp_path, "ref.txt")
    ref_echo = capsys.readouterr().out

    out = _sink(sink, tmp_path, "port.txt")
    norms = [writers.write_display77_from_record(out, tm, recs,
                                                 quiet=quiet)
             for recs in chunks]
    text = _text(sink, out, tmp_path, "port.txt")
    echo = capsys.readouterr().out

    assert text == ref_text
    assert echo == ref_echo
    assert (echo if sink == "stdout" else text).count("\n") >= 2 * len(
        ref_norms)
    assert (ref_echo != "") == (not quiet or sink == "stdout")
    np.testing.assert_array_equal(np.concatenate(norms),
                                  np.asarray(ref_norms))


def test_the_run_hands_the_writer_one_stack_a_chunk():
    chunks = run_records("f32")
    assert all(c.ndim == 2 and c.shape[1] >= 11 for c in chunks)
    assert max(map(len, chunks)) > 1


def test_the_counters_count_each_record_once_while_spans_record(formatter):
    _, tm = models("f32")
    recs = run_records("f32")[0]
    before = tracing.counters()
    writers.write_display77_from_record(io.StringIO(), tm, recs,
                                        quiet=True)
    assert tracing.counters() == before
    with tracing.recording():
        writers.write_display77_from_record(io.StringIO(), tm, recs,
                                            quiet=True)
        writers.write_display77_from_record(io.StringIO(), tm, recs[:1],
                                            quiet=True)
    after = tracing.counters()
    grown = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert grown.get("io.records") == len(recs) + 1
    assert grown.get("io.records_native", 0) == (
        len(recs) + 1 if formatter == "native" else 0)


def test_a_cpu_run_builds_no_formatter(monkeypatch):
    """Only a card's display-77 run builds io/libd77fmt.so as it is set
    up; a CPU run formats with whatever is built."""
    def build():
        raise AssertionError("build_d77 on a CPU run")
    monkeypatch.setattr(native, "build_d77", build)
    Simulation(SimConfig(**TINY, dtype="f32", out_file="/dev/null",
                         impl="torch"), device=torch.device("cpu"))
