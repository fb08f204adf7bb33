"""A configuration, a traffic mix, a metric and a cell added as new files
and entries in a copy of the benchmark are found without an edit."""

import json
import os
import shutil

import pytest

from conftest import BENCH_DIR, REPO_DIR
from harness import spec


@pytest.fixture
def copy_with_new_cell(tmp_path):
    repo = tmp_path / "repo"
    shutil.copytree(BENCH_DIR, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(REPO_DIR, "BENCHMARK.json")))
    b = repo / "benchmark"
    cfg = json.load(open(b / "configs" / "hires_n100_m4000.json"))
    cfg["args"].update({"n-harmonics": 20, "g-grid": 200})
    json.dump(cfg, open(b / "configs" / "small_n20_m200.json", "w"))
    mix = json.load(open(b / "traffic" / "d4_long.json"))
    mix["args"]["display"] = 77
    json.dump(mix, open(b / "traffic" / "d77_series.json", "w"))
    (b / "metrics" / "records_per_run.py").write_text(
        "def read(rec):\n    return 42.0\n")
    json.dump({"gap": {"limit": 1e-3}},
              open(b / "limits" / "small.d77.json", "w"))
    bench["configs"].append(dict(bench["configs"][0], name="small_n20_m200",
                                 file="benchmark/configs/small_n20_m200.json"))
    bench["workloads"].append({"name": "small.d77", "config":
                               "small_n20_m200", "traffic": "d77_series",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "records_per_run", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "writers", "moves":
                               "site_updates_per_s",
                               "workloads": ["small.d77"]})
    json.dump(bench, open(repo / "BENCHMARK.json", "w"))
    return repo


def test_new_files_and_entries_are_found(copy_with_new_cell):
    repo = copy_with_new_cell
    cell = spec.load_cell("small.d77", repo=str(repo))
    assert cell.config["args"]["g-grid"] == 200
    assert cell.traffic["args"]["display"] == 77
    assert cell.limits["gap"]["limit"] == 1e-3
    names = [m["name"] for m in cell.per_layer]
    assert "records_per_run" in names
    read = spec.reader("records_per_run",
                       bench_dir=str(repo / "benchmark"))
    assert read(None) == 42.0
    # the cells that were there do not report the new metric
    old = spec.load_cell("hires.d4", repo=str(repo))
    assert "records_per_run" not in [m["name"] for m in old.per_layer]


def test_every_cell_of_the_benchmark_loads_with_its_readers():
    bench = json.load(open(os.path.join(REPO_DIR, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        assert cell.limits["gap"]["limit"] is not None
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert {m["moves"] for m in cell.per_layer} <= names
