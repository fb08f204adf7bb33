"""io/native.build() of the port: native/libslbio.so is made by `make -C
native` (native/Makefile's recipe, CXX from the environment) and then
writes the rows; a failed build leaves the Python formatter, which
formatter() names with the build's error.  The same of build_d77() and
the port's display-77 formatter, io/libd77fmt.so.  Each case builds in a
copy of the sources under a temporary root."""

import os
import shutil

import pytest

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch.io import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """native's state as if nothing were loaded, its root a temporary copy
    of native/ without a built library."""
    os.makedirs(tmp_path / "native")
    for f in ("Makefile", "slbio.cpp"):
        shutil.copy(os.path.join(ROOT, "native", f), tmp_path / "native")
    monkeypatch.setattr(native, "_root", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)
    # the copy is the only candidate: no library beside the module
    assert not os.path.exists(os.path.join(
        os.path.dirname(native.__file__), "libslbio.so"))
    return tmp_path


def test_build_makes_the_library_and_loads_it(fresh):
    assert native.build() == "native (native/libslbio.so)"
    assert os.path.exists(fresh / "native" / "libslbio.so")
    assert native.count_steps_f32(0.0, 1.0, 0.25) is not None


def test_a_failed_build_names_the_python_formatter(fresh, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("CXX", "false")
    got = native.build()
    assert got.startswith("python (build failed: ") and "Error" in got
    assert "make -C native failed" in capsys.readouterr().err
    assert not os.path.exists(fresh / "native" / "libslbio.so")
    assert native.formatter() == got


@pytest.fixture
def fresh_d77(tmp_path, monkeypatch):
    """The display-77 formatter's state as if nothing were loaded, its
    directory a temporary copy of io/'s Makefile and d77fmt.cpp without a
    built library."""
    for f in ("Makefile", "d77fmt.cpp"):
        shutil.copy(os.path.join(ROOT, "slb2d_tpu_torch", "io", f), tmp_path)
    monkeypatch.setattr(native, "_d77_dir", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_D77", None)
    monkeypatch.setattr(native, "_D77_TRIED", False)
    monkeypatch.setattr(native, "_D77_BUILD_ERROR", None)
    return tmp_path


def test_build_d77_makes_the_library_and_loads_it(fresh_d77):
    assert native.build_d77() == "native (io/libd77fmt.so)"
    assert os.path.exists(fresh_d77 / "libd77fmt.so")
    assert [p.name for p in fresh_d77.iterdir()
            if p.name.startswith("libd77fmt.so.")] == []
    assert native.format_d77_rows([[0.5] * 15], "", echo=False,
                                  lines=True) == " ".join(
        ["0.50000000000000000000"] * 15) + "\n"


def test_a_failed_build_d77_names_the_python_formatter(fresh_d77,
                                                       monkeypatch, capsys):
    monkeypatch.setenv("CXX", "false")
    got = native.build_d77()
    assert got.startswith("python (build failed: ") and "Error" in got
    assert "failed; the Python formatter" in capsys.readouterr().err
    assert not os.path.exists(fresh_d77 / "libd77fmt.so")
    assert native.format_d77_rows([[0.5] * 15], "", echo=False,
                                  lines=True) is None


def test_the_d77_formatter_writes_what_python_writes(fresh_d77):
    """slb_format_d77_rows against Python's '%.20f' over ~1e5 doubles at
    exponents 1e-30 to 1e17, with zeros of either sign, subnormals, ties,
    the largest doubles, infinities and NaN of either sign; the echo lines
    of column 13 (t) and 6 (the norm)."""
    import numpy as np
    assert native.build_d77().startswith("native")
    rng = np.random.default_rng(20)
    mags = 10.0 ** rng.uniform(-30, 17, 100_005)
    vals = rng.choice([-1.0, 1.0], mags.size) * mags
    vals[::7] = vals[::7].astype(np.float32)
    nan = float("nan")
    edge = [0.0, -0.0, 5e-324, -5e-324, 2.2e-308, 1e15, -1e15,
            np.nextafter(1e15, 0), 2.0 ** 53 + 2, 1e17, 1e300, -1.7e308,
            float("inf"), float("-inf"), nan, float(np.copysign(nan, -1)),
            0.5, 0.1, 1 / 3, 2.0 ** -21, 3 * 2.0 ** -21, 7.0 + 2.0 ** -21,
            float(np.float32(2.0 ** -21 * 5))]
    vals = np.concatenate([edge, vals])
    rows = vals[:vals.size // 15 * 15].reshape(-1, 15)
    got = native.format_d77_rows(rows, "#h\n", echo=True, lines=True)
    want = "".join("\n# t=%.20f norm=%.20f\n" % (r[13], r[6]) + "#h\n"
                   + " ".join("%.20f" % x for x in r) + "\n"
                   for r in rows.tolist())
    assert got == want
    assert native.format_d77_rows(rows[:3], "#h\n", echo=True,
                                  lines=False) == "".join(
        "\n# t=%.20f norm=%.20f\n" % (r[13], r[6]) for r in rows[:3].tolist())
