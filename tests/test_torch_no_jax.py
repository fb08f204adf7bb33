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
    assert "slb2d_tpu_torch.runtime.loop" in mods
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
