"""On a card: a short run of each cell prints a correct result with the
contract's keys, and a traced one its per-layer metrics."""

import json
import subprocess
import sys

import pytest

from conftest import REPO_DIR

CELLS = ("hires.d4", "hires.d77", "map.paper", "map.edc64")


def _result(name, trace):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_a_short_run_on_the_card(cuda_device, name, trace):
    out = _result(name, trace)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 < out["metrics"]["kernel_roofline_pct"]["value"] < 100
    else:
        assert out["metrics"]["site_updates_per_s"]["value"] > 0
