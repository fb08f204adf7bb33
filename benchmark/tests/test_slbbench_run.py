"""run.py refuses without a card and without the program; the reference
imports nothing of the program or of JAX; a run loading JAX or the JAX
package is caught by whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, REPO_DIR
from harness import window

ARGS = ["--workload", "hires.d4", "--seed", str(2**31 + 5), "--seconds",
        "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(REPO_DIR, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), tmp_path)
    p = _run(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


FORBIDDEN = ("slb2d_tpu_torch", "slb2d_tpu", "jax", "jaxlib")


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.solver, json; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code, BENCH_DIR],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(BENCH_DIR))
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_banned_modules_compare_whole_top_level_names():
    assert window.banned_modules(["slb2d_tpu_torch", "slb2d_tpu_torch.ops",
                                  "torch", "jaxtyping"]) == []
    assert window.banned_modules(["slb2d_tpu.ops.stencil"]) == ["slb2d_tpu"]
    assert window.banned_modules(["jax._src.core", "jaxlib"]) == [
        "jax", "jaxlib"]
