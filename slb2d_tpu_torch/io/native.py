"""ctypes bridges to the native C++ IO helpers.

Two formatters of the hot text are native, like the reference (whose
entire runtime is C):

- frame emission, millions of printf-formatted rows per frame, genuinely
  hot in movie mode (display 7): native/slbio.cpp, the library the JAX
  package loads too (`make -C native`, or build() below); formatter()
  names the one that writes;
- the display-77 lines, ~1,600 records of 15 columns in a run at display
  77, one call per chunk: io/d77fmt.cpp, the port's own
  (`make -C slb2d_tpu_torch/io`, or build_d77() below, which a card's
  display-77 run calls as it is set up); d77_formatter() names the one
  that writes.

Each falls back to its Python path, the same bytes, where its library has
not been built.
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
        err = _make(native, "libslbio.so")
        if err is not None:
            _BUILD_ERROR = err.splitlines()[-1] if err else "no output"
            print(f"io/native: make -C native failed; the Python formatter "
                  f"writes the rows:\n{err}", file=sys.stderr)
    if _LIB is None:
        _TRIED = False
    return formatter()


def _make(where, target):
    """`make -C where target`: None where it succeeded, else its output
    (or the error that kept it from running)."""
    try:
        run = subprocess.run(["make", "-C", where, target],
                             capture_output=True, text=True, timeout=300)
        return (run.stdout + run.stderr).strip() if run.returncode else None
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"


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


# ---- the display-77 formatter (io/d77fmt.cpp, libd77fmt.so beside it) ----

_D77 = None
_D77_TRIED = False
_D77_BUILD_ERROR = None


def _d77_dir():
    return os.path.dirname(os.path.abspath(__file__))


def _load_d77():
    global _D77, _D77_TRIED
    if _D77_TRIED:
        return _D77
    _D77_TRIED = True
    path = os.path.join(_d77_dir(), "libd77fmt.so")
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.slb_format_d77_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong]
            lib.slb_format_d77_rows.restype = ctypes.c_longlong
            _D77 = lib
        except (OSError, AttributeError):
            pass   # unloadable or stale: the Python formatter writes
    return _D77


def build_d77():
    """Build io/libd77fmt.so with `make -C slb2d_tpu_torch/io` (its
    Makefile, the one recipe; CXX and CXXFLAGS pass through the
    environment; the library is gitignored, and renamed into place whole)
    when it is missing or older than d77fmt.cpp, and load it.  Returns
    d77_formatter().  A failed build leaves the Python formatter in place:
    the build's error goes to stderr, and d77_formatter() names it."""
    global _D77, _D77_TRIED, _D77_BUILD_ERROR
    here = _d77_dir()
    lib = os.path.join(here, "libd77fmt.so")
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(
            os.path.join(here, "d77fmt.cpp")):
        err = _make(here, "libd77fmt.so")
        if err is not None:
            _D77_BUILD_ERROR = err.splitlines()[-1] if err else "no output"
            print(f"io/native: make -C {here} failed; the Python formatter "
                  f"writes the display-77 lines:\n{err}", file=sys.stderr)
    if _D77 is None:
        _D77_TRIED = False
    return d77_formatter()


def d77_formatter() -> str:
    """The formatter display-77 lines go through: "native
    (io/libd77fmt.so)" or "python" (io/writers.py's Python path; after a
    failed build_d77(), "python (build failed: <its error's last
    line>)")."""
    if _load_d77() is not None:
        return "native (io/libd77fmt.so)"
    return "python" if _D77_BUILD_ERROR is None else \
        f"python (build failed: {_D77_BUILD_ERROR})"


def format_d77_rows(rows, head: str, *, echo: bool, lines: bool):
    """The display-77 text of a chunk's records (slb_format_d77_rows):
    rows (R, 15), each record's line columns; with `echo` its stdout echo
    (an empty line, then "# t=<t> norm=<norm>"), with `lines` `head` and
    the row.  None without the library."""
    lib = _load_d77()
    if lib is None:
        return None
    v = np.ascontiguousarray(rows, np.float64)
    if v.ndim != 2 or v.shape[1] != 15:
        raise ValueError(f"display-77 rows are (R, 15), not {v.shape}")
    # a value takes <= 37 chars below 1e15, <= 331 above (twice if echoed)
    cap = len(v) * (len(head) + 16 * 40 + 88) + 2 * 300 * int(
        np.count_nonzero(~(np.abs(v) < 1e15))) + 1
    buf = np.empty(cap, np.uint8)
    n = lib.slb_format_d77_rows(v.ctypes.data, len(v), head.encode(),
                                int(echo), int(lines), buf.ctypes.data, cap)
    return None if n < 0 else buf[:n].tobytes().decode("ascii")
