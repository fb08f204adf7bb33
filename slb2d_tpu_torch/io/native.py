"""ctypes bridge to the native C++ IO helpers (native/slbio.cpp).

Frame emission is millions of printf-formatted lines per frame — genuinely
hot in movie mode (display 7), so like the reference (whose entire runtime
is C) the formatter is native.  Falls back to the Python path when the
shared library has not been built (`make -C native`, or build() below);
formatter() names the one that writes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False
_BUILD_ERROR = None   # the last line of a failed build()'s error


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = _root()
    for cand in (os.path.join(here, "native", "libslbio.so"),
                 os.path.join(os.path.dirname(__file__), "libslbio.so")):
        if not os.path.exists(cand):
            continue
        try:
            lib = ctypes.CDLL(cand)
            lib.slb_write_xy_rows.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double)]
            lib.slb_write_xy_rows.restype = ctypes.c_int
            lib.slb_count_steps_f32.argtypes = [
                ctypes.c_float, ctypes.c_float, ctypes.c_float]
            lib.slb_count_steps_f32.restype = ctypes.c_longlong
            _LIB = lib
            break
        except OSError:
            continue   # unloadable copy: try the next candidate
    return _LIB


def _root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def build():
    """Build native/libslbio.so with `make -C native` (native/Makefile,
    the one recipe; CXX and CXXFLAGS pass through the environment; the
    library is gitignored) when it is missing, and load it.  Returns
    formatter().  A failed build leaves the Python formatter in place:
    the build's error goes to stderr, and formatter() names the Python
    path with the error's last line."""
    global _LIB, _TRIED, _BUILD_ERROR
    native = os.path.join(_root(), "native")
    if not os.path.exists(os.path.join(native, "libslbio.so")):
        try:
            run = subprocess.run(["make", "-C", native, "libslbio.so"],
                                 capture_output=True, text=True,
                                 timeout=300)
            err = (run.stdout + run.stderr).strip() if run.returncode \
                else None
        except (OSError, subprocess.SubprocessError) as e:
            err = f"{type(e).__name__}: {e}"
        if err is not None:
            _BUILD_ERROR = err.splitlines()[-1] if err else "no output"
            print(f"io/native: make -C native failed; the Python formatter "
                  f"writes the rows:\n{err}", file=sys.stderr)
    if _LIB is None:
        _TRIED = False
    return formatter()


def formatter() -> str:
    """The formatter frame rows go through: "native (native/libslbio.so)"
    or "python" (io/writers.py's Python path; after a failed build(),
    "python (build failed: <its error's last line>)")."""
    if _load() is not None:
        return "native (native/libslbio.so)"
    return "python" if _BUILD_ERROR is None else \
        f"python (build failed: {_BUILD_ERROR})"


def write_xy_rows_native(out, phi_x, phi_y, F) -> bool:
    """Append formatted '%0.5f %0.5f %0.20f' triplets to `out`.

    Only usable when `out` is a real file (has fileno and a path-backed
    buffer); returns False to fall back otherwise.
    """
    lib = _load()
    if lib is None:
        return False
    name = getattr(out, "name", None)
    if not isinstance(name, str) or name.startswith("<"):
        return False
    out.flush()
    px = np.ascontiguousarray(phi_x, np.float64)
    py = np.ascontiguousarray(phi_y, np.float64)
    Fv = np.ascontiguousarray(F, np.float64)
    ok = lib.slb_write_xy_rows(
        name.encode(),
        px.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(px),
        py.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(py),
        Fv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if ok == 0:
        # the Python handle must resume after the natively-appended rows
        out.seek(0, os.SEEK_END)
        return True
    return False


def count_steps_f32(t0: float, t_max: float, dt: float):
    """Native float32 loop-trip counter; None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.slb_count_steps_f32(
        ctypes.c_float(t0), ctypes.c_float(t_max), ctypes.c_float(dt)))
