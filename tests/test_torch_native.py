"""io/native.build() of the port: native/libslbio.so is made by `make -C
native` (native/Makefile's recipe, CXX from the environment) and then
writes the rows; a failed build leaves the Python formatter, which
formatter() names with the build's error.  Each case builds in a copy of
native/ under a temporary root."""

import os
import shutil

import pytest

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
