"""Runs across processes: two Gloo worker processes with 4 CPU slots each,
spawned as tests/test_multihost*.py spawn theirs, each with its own
timeout (a hang fails the test instead of stalling the suite).

  (a) an 8-slot "sweep" mesh: both processes hold the whole table, equal
      bit for bit to the one-process run on 8 slots;
  (b) the driver across the process boundary, f64 shards=8 on impl=torch
      (the sharded plain scan): display 7, then display 4 with one REPL
      mutation (process 0 reads and broadcasts it) and checkpoint=, which
      process 0 alone writes.  Bit for bit with the one-process 8-slot run
      (the slot-order sums make that possible), within 1e-12 of the
      unsharded run;
  (c) the sharded form of B2's plain version across processes
      (impl=stream), f32, with a REPL mutation, bit for bit with the
      one-process run on the same slots;
  (d) the combined sweep x space layout on a (1, 2) mesh of one slot a
      process, the halo and the sums across the process boundary: both
      processes hold the whole table, the one-process run's bit for bit.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
from slb2d_tpu_torch.runtime.loop import Simulation

CPU = torch.device("cpu")
COMMON = dict(E_dc=1.0, E_omega=2.0, omega=40.0, mu=1.0, alpha=0.9495,
              n_harmonics=8, phi_y_min=-5.0, phi_y_max=5.0, B=0.1,
              t_start=0.02, g_grid=125, dt=1e-3, quiet=True)
RUNS = {"d7": dict(display=7, dtype="f64", impl="torch", frame_batch=4),
        "d4": dict(display=4, dtype="f64", impl="torch",
                   checkpoint="ck.npz"),
        "d4s": dict(display=4, dtype="f32", impl="stream")}
REPL = {"d4": "E_dc 1.5 0.05\nexit\n", "d4s": "B 0.15 0.05\nexit\n"}
SWEEP = dict(display=4, E_dc=1.0, E_omega=2.0, omega=30.0, mu=1.0,
             alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
             B=0.1, t_start=0.05, g_grid=24, dt=1e-3, quiet=True,
             impl="torch")
E_DCS = list(np.linspace(0.25, 2.0, 8))
# the combined layout's run: 52 steps
COMBINED = dict(SWEEP, omega=150.0, t_start=0.01)
TIMEOUT = 120

WORKER = r'''
import io, json, os, sys
rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
import torch_support  # one torch thread
from slb2d_tpu_torch.parallel.mesh import init_distributed, make_mesh
assert init_distributed("127.0.0.1:" + port, 2, rank, backend="gloo")
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.parallel import ParameterSweep
from slb2d_tpu_torch.runtime.loop import Simulation
from tests.test_torch_multihost import (COMBINED, COMMON, E_DCS, REPL,
                                        RUNS, SWEEP)
CPU = torch.device("cpu")
os.chdir(outdir)
mesh = make_mesh((8,), ("space",), devices=[CPU] * 4)
assert [s.rank for s in mesh.slots] == [0] * 4 + [1] * 4
for name, kw in RUNS.items():
    sim = Simulation(SimConfig(**COMMON, **kw, shards=8,
                               out_file=name + ".txt"), mesh=mesh)
    repl = REPL.get(name)
    sim.run(repl_stream=None if repl is None else io.StringIO(repl))
res = ParameterSweep(SimConfig(**SWEEP), {"E_dc": np.array(E_DCS)},
                     mesh=make_mesh((8,), ("sweep",),
                                    devices=[CPU] * 4)).run()
with open(f"sweep.{rank}.json", "w") as fh:
    json.dump({k: np.asarray(v).tolist() for k, v in res.items()}, fh)
res = ParameterSweep(SimConfig(**COMBINED), {"E_dc": np.array(E_DCS)},
                     mesh=make_mesh((1, 2), ("sweep", "space"),
                                    devices=[CPU]), space_axis="space").run()
with open(f"combined.{rank}.json", "w") as fh:
    json.dump({k: np.asarray(v).tolist() for k, v in res.items()}, fh)
# both ranks past their last collective before gloo's threads go: a rank
# that exits while its peer still holds the connection can abort at exit
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("worker", rank, "done", flush=True)
'''


def _free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """The workers' output directory, after both exited 0."""
    root = tmp_path_factory.mktemp("mh")
    script = root / "worker.py"
    script.write_text(WORKER)
    out = root / "out"
    out.mkdir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, os.path.join(repo, "tests"), env.get("PYTHONPATH", "")])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), port, str(out)], env=env,
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-3000:]
    return out


def _one_process(d, shards, mesh=None):
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for name, kw in RUNS.items():
            sim = Simulation(SimConfig(**COMMON, **kw, shards=shards,
                                       out_file=name + ".txt"),
                             device=CPU, mesh=mesh)
            repl = REPL.get(name)
            sim.run(repl_stream=None if repl is None else io.StringIO(repl))
    finally:
        os.chdir(cwd)
    return d


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("one")
    return (_one_process(str(root / "slots8"), 8,
                         make_mesh((8,), ("space",), devices=[CPU] * 8)),
            _one_process(str(root / "unsharded"), 1))


def _frames(d):
    return sorted(f for f in os.listdir(d) if f.startswith("frame"))


def test_two_process_sweep_matches_one_process(two_process_runs):
    tables = [json.load(open(two_process_runs / f"sweep.{i}.json"))
              for i in range(2)]
    assert tables[0] == tables[1]
    ref = ParameterSweep(SimConfig(**SWEEP), {"E_dc": np.array(E_DCS)},
                         mesh=make_mesh((8,), ("sweep",),
                                        devices=[CPU] * 8)).run()
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(tables[0][k]),
                                      np.asarray(v), err_msg=k)


def test_two_process_combined_sweep_matches_one_process(two_process_runs):
    """The (1, 2) combined layout across the two processes: the table of
    the one-process run on two slots, bit for bit, on both processes."""
    tables = [json.load(open(two_process_runs / f"combined.{i}.json"))
              for i in range(2)]
    assert tables[0] == tables[1]
    ref = ParameterSweep(SimConfig(**COMBINED), {"E_dc": np.array(E_DCS)},
                         mesh=make_mesh((1, 2), ("sweep", "space"),
                                        devices=[CPU] * 2),
                         space_axis="space").run()
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(tables[0][k]),
                                      np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", ["d4.txt", "d4s.txt"])
def test_two_process_lines_match_one_process(two_process_runs,
                                             one_process_runs, name):
    """Display 4 (two rounds: the REPL mutation broadcast by process 0) on
    the plain scan and on the sharded form of B2: byte for byte with the
    one-process run on the same 8 slots."""
    got = (two_process_runs / name).read_text()
    assert got == open(os.path.join(one_process_runs[0], name)).read()
    assert len([l for l in got.splitlines()
                if l and not l.startswith("#")]) == 2


def test_two_process_frames_match_one_process(two_process_runs,
                                              one_process_runs):
    """Display 7's frames: written by process 0 alone, the files of the
    one-process 8-slot run byte for byte, the unsharded run's names."""
    slots8, unsharded = one_process_runs
    frames = _frames(two_process_runs)
    assert frames == _frames(slots8) == _frames(unsharded)
    assert len(frames) >= 5
    for f in frames:
        assert (two_process_runs / f).read_text() == \
            open(os.path.join(slots8, f)).read(), f


def test_two_process_checkpoint_is_the_whole_state(two_process_runs,
                                                   one_process_runs):
    """checkpoint=: one file, the whole state in the unsharded format, bit
    for bit with the one-process 8-slot run's and, in the state arrays,
    with the unsharded run's."""
    slots8, unsharded = one_process_runs
    a = np.load(two_process_runs / "ck.npz")
    b = np.load(os.path.join(slots8, "ck.npz"))
    c = np.load(os.path.join(unsharded, "ck.npz"))
    assert sorted(a.files) == sorted(b.files) == sorted(c.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("state_a", "state_b", "state_a_hs", "state_b_hs",
              "state_hs_edge_a", "state_hs_edge_b", "state_step"):
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


@pytest.mark.parametrize("name,tol", [
    ("d4.txt", dict(rtol=1e-12, atol=1e-15)),
    ("d4s.txt", dict(rtol=1e-4, atol=5e-7))])
def test_two_process_lines_match_unsharded(two_process_runs,
                                           one_process_runs, name, tol):
    """Against the unsharded one-process run: f64 within 1e-12 (the order
    of the sums), f32 B2 at its TOL; headers byte for byte."""
    got = (two_process_runs / name).read_text().splitlines()
    ref = open(os.path.join(one_process_runs[1], name)).read().splitlines()
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        if x.startswith("#") or not x:
            assert x == y
            continue
        np.testing.assert_allclose(np.array(x.split(), float),
                                   np.array(y.split(), float), **tol)
