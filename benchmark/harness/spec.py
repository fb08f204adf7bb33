"""What BENCHMARK.json names, found by name among the benchmark's files.

A cell of BENCHMARK.json names a configuration and a traffic mix; each
metric has a reader.  They are files of their own, found by name:

  configs/<config>.json        the configuration (BENCHMARK.json gives
                               its path under "file")
  traffic/<traffic>.json       the traffic mix, read by harness/traffic.py
  metrics/<metric>.py          the metric's reader: read(record) -> value
                               or None
  limits/<cell>.json           the limits of the numbers that decide
                               `correct`, with the readings they were set
                               from

so that a configuration, a mix, a metric or a cell is added by adding
files and entries, with no edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json's entries that this cell reports
    per_layer: list
    limits: dict          # {number: {"limit": ..., ...}}


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, repo=REPO_DIR, bench_dir=None):
    """The cell `name` of repo/BENCHMARK.json with its files."""
    bench_dir = bench_dir or os.path.join(repo, "benchmark")
    bench = _json(os.path.join(repo, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(repo, conf["file"])),
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits=_json(os.path.join(bench_dir, "limits", name + ".json")))


def reader(metric_name, bench_dir=BENCH_DIR):
    """The read(record) function of metrics/<metric_name>.py."""
    path = os.path.join(bench_dir, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slbbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
