"""Build and load the CUDA kernel library (csrc/*.cu) at first use.

One ``nvcc`` per source, all started together, compiles the kernels to
objects; one more links them into a shared library with a plain C
interface, ``build/slb2d_tpu_torch/libslbstep_<hash>.so`` beside the
package, keyed by a hash of the sources, headers and flags so an edited
source builds anew.  The library is loaded with ctypes.  Nothing here runs
at import time; a missing ``nvcc`` or a failed build raises.
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
SOURCES = tuple(os.path.join(_PKG, "csrc", f)
                for f in ("stepper.cu", "sweep_stack.cu",
                          "stepper_stream.cu", "sweep_lanes.cu",
                          "probe_vpu.cu", "probe_roll.cu",
                          "probe_transposed.cu"))
HEADERS = tuple(os.path.join(_PKG, "csrc", f)
                for f in ("half_step.cuh", "band_step.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "slb2d_tpu_torch")
# -fmad=false: no multiply-add contraction, so the kernel rounds as the
# plain version and the float C reference do: it then matches the plain
# version (reciprocal form) bit for bit.  With contraction, the float
# kernel was 8.2e-7 abs from the plain exact-division form after 251 steps
# at BASELINE #4, outside rtol 1e-4, atol 1e-7 (H100 80GB HBM3, 700 W;
# PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures: (pointers, ints, stream) per entry point
_ENTRY_ARGS = {
    "slb_run_chunk": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p]),
    "slb_resident_chunk": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p]),
    "slb_resident_info": [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "slb_sweep_chunk": ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p]),
    "slb_sweep_chunk_omega": ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p]),
    "slb_sweep_form_info": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "slb_stream_chunk": ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p]),
    "slb_stream_spill_chunk": ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
                               + [ctypes.c_void_p]),
    "slb_stream_spill_info": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "slb_lanes_chunk": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p]),
    "slb_lanes_cluster": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p]),
    "slb_lanes_form_info": [ctypes.c_int] * 4 + [ctypes.c_void_p],
    # the tests/perf probes P1-P3 (slb2d_tpu_torch/perf/)
    "slb_vpu_chain": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p]),
    "slb_roll_passes": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p]),
    "slb_roll_registers": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p]),
    "slb_transposed_chunk": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p]),
    "slb_transposed_resident": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                                + [ctypes.c_void_p]),
    "slb_transposed_resident_info": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "slb_transposed_step_info": [ctypes.c_void_p],
}
# the float and double symbols of each entry; the lane-packed sweep kernel
# and the probes are float-only, as the JAX kernels they replace; the
# form queries of the step and sweep kernels take the type as an argument
_ENTRY_TYPES = {name: ("_f32",) for name in (
    "slb_lanes_chunk", "slb_lanes_cluster", "slb_vpu_chain", "slb_roll_passes",
    "slb_roll_registers", "slb_transposed_chunk", "slb_transposed_resident")}
_ENTRY_TYPES["slb_sweep_form_info"] = ("",)
_ENTRY_TYPES["slb_resident_info"] = ("",)
_ENTRY_TYPES["slb_lanes_form_info"] = ("",)
_ENTRY_TYPES["slb_stream_spill_info"] = ("",)
_ENTRY_TYPES["slb_transposed_resident_info"] = ("",)
_ENTRY_TYPES["slb_transposed_step_info"] = ("",)


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
    for src in SOURCES + HEADERS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslbstep_{h.hexdigest()[:16]}.so")


def load() -> _Lib:
    """The kernel library, built first if no build of these sources
    exists."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    path = library_path()
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            log = _compile_and_link(tmpdir, path)
        seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(path)
    for entry, argtypes in _ENTRY_ARGS.items():
        for suffix in _ENTRY_TYPES.get(entry, ("_f32", "_f64")):
            fn = getattr(cdll, entry + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _LOADED = _Lib(cdll, path, seconds, log)
    return _LOADED


def _compile_and_link(tmpdir, path) -> str:
    """Compile every source in parallel, link, move the library to path;
    returns the compilers' output (ptxas register counts included)."""
    nvcc = _nvcc()
    objs = [os.path.join(tmpdir, os.path.basename(src) + ".o")
            for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                             f"{' '.join(cmd)}\n{out}")
    lib = os.path.join(tmpdir, "lib.so")
    cmd = [nvcc, "-shared", "-o", lib, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc link failed ({proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{log}")
    os.replace(lib, path)   # atomic: concurrent builders never see a
                            # half-written library
    return log
