"""The benchmark's tests: sys.path for the harness and the program, and
the cells cut to a tiny grid that the CPU runs in seconds."""

import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
for p in (REPO_DIR, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# each cell at a grid and a length the CPU runs in seconds, on the plain
# tensor engine: (config args, traffic changes, settings of every request)
TINY = {
    "hires.d4": ({"n-harmonics": 6, "g-grid": 24}, {},
                 {"t-max": 0.05, "omega": 40.0}),
    "hires.d77": ({"n-harmonics": 6, "g-grid": 24}, {},
                  {"t-max": 0.05, "omega": 40.0}),
    "map.paper": ({"n-harmonics": 5, "g-grid": 16},
                  {"grid": {"E_dc": {"linspace": [0.0, 3.0, 3]},
                            "omega": {"linspace": [30.0, 50.0, 3]}},
                   "warm": {"t-max": 0.01}, "check": {"requests": 1,
                                                      "points": 4}},
                  {"t-max": 0.05}),
    "map.edc64": ({"n-harmonics": 5, "g-grid": 16},
                  {"grid": {"E_dc": {"linspace": [0.1, 3.0, 5]}},
                   "warm": {"omega": 80.0}, "check": {"requests": 1,
                                                      "points": 3}},
                  {"t-max": 0.02, "omega": 40.0}),
}


def tiny_cell(name):
    """(cell, settings for every request) of `name` at its tiny size on
    the CPU."""
    from harness import spec
    cell = copy.deepcopy(spec.load_cell(name))
    args, traffic, extra = TINY[name]
    cell.config["args"].update(args)
    cell.traffic.update(copy.deepcopy(traffic))
    return cell, dict(extra, device="cpu", impl="torch")


@pytest.fixture
def cuda_device():
    """A CUDA device, decided when the test runs; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")
