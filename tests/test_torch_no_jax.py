"""The PyTorch port imports neither jax nor the JAX package."""

import os
import pkgutil
import subprocess
import sys

import slb2d_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = ["slb2d_tpu_torch"]
    for info in pkgutil.walk_packages(slb2d_tpu_torch.__path__,
                                      "slb2d_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "slb2d_tpu_torch.ops.stepper_cuda" in mods
    assert "slb2d_tpu_torch.ops.stepper_stream_cuda" in mods
    assert "slb2d_tpu_torch.runtime.loop" in mods
    for m in ("slb2d_tpu_torch.parallel.sweep",
              "slb2d_tpu_torch.ops.sweep_stack_cuda",
              "slb2d_tpu_torch.sweep_cli",
              "slb2d_tpu_torch.ops.frames",
              "slb2d_tpu_torch.absorption_map",
              "slb2d_tpu_torch.ops.sweep_lanes_cuda",
              "slb2d_tpu_torch.bench",
              "slb2d_tpu_torch.perf.vpu_roofline",
              "slb2d_tpu_torch.perf.roll_cost_experiment",
              "slb2d_tpu_torch.perf.transposed_experiment"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'slb2d_tpu',\n"
        "                                    'triton'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
