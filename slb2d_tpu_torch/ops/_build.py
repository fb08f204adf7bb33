"""Build and load the CUDA step library (csrc/stepper.cu) at first use.

``nvcc`` compiles the source into a shared library with a plain C
interface, ``build/slb2d_tpu_torch/libslbstep_<hash>.so`` beside the
package, keyed by a hash of the sources and flags so an edited source
builds anew.  The library is loaded with ctypes.  Nothing here runs at
import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "stepper.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "slb2d_tpu_torch")
# -fmad=false: no multiply-add contraction, so the kernel rounds as the
# plain version and the float C reference do: it then matches the plain
# version (reciprocal form) bit for bit.  With contraction, the float
# kernel was 8.2e-7 abs from the plain exact-division form after 251 steps
# at BASELINE #4, outside rtol 1e-4, atol 1e-7 (H100 80GB HBM3, 700 W;
# PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_ENTRY_ARGS = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
               + [ctypes.c_void_p])


class BuildError(RuntimeError):
    pass


class _Lib:
    """The loaded library and what its build reported."""

    def __init__(self, cdll, path, seconds, log):
        self.cdll = cdll
        self.path = path
        self.build_seconds = seconds   # 0.0 when the library was cached
        self.build_log = log


_LOADED: _Lib | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin): cannot build the CUDA "
                         "step kernel")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslbstep_{h.hexdigest()[:16]}.so")


def load() -> _Lib:
    """The step library, built first if no build of these sources exists."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    path = library_path()
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                             f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, path)   # atomic: concurrent builders never see
                                # a half-written library
    cdll = ctypes.CDLL(path)
    for name in ("slb_run_chunk_f32", "slb_run_chunk_f64"):
        fn = getattr(cdll, name)
        fn.argtypes = _ENTRY_ARGS
        fn.restype = ctypes.c_int
    _LOADED = _Lib(cdll, path, seconds, log)
    return _LOADED
