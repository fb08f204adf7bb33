"""ctypes bridge to the native C++ IO helpers (native/slbio.cpp).

Frame emission is millions of printf-formatted lines per frame — genuinely
hot in movie mode (display 7), so like the reference (whose entire runtime
is C) the formatter is native.  Falls back to the Python path when the
shared library has not been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
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
