"""The combined sweep x space layout (slb2d_tpu_torch/parallel/sweep.py,
``space_axis=``; the sweep CLI's ``shards>1``) and the sharded runs'
constants (no whole-grid constant on a slot's device).

Against the JAX package's combined sweep (the run of
tests/test_parallel.py's test_sweep_combined_space_mesh_matches_plain, on
the (2, 4) mesh of the 8 virtual CPU devices tests/conftest.py gives
JAX; the port on 8 CPU slots): f64 at 1e-12, f32 at
tests/test_torch_sweep.py's 2e-4 / 2e-5 (XLA contracts multiply-adds on
the CPU, the port does not).  Against the port's one-device sweep: the
state bit for bit (the layout changes only the order of the sums over
m), ragged blocks and per-point windows included; checkpoints resume
across layouts; the CLI's shards=.  Every run is N=8, g-grid 24 (MP=128)
and 52-62 steps (omega 150, t-start 0.01)."""

import numpy as np
import pytest
import torch

import jax

from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.parallel import ParameterSweep as JSweep
from slb2d_tpu.parallel import make_mesh as jax_mesh

from slb2d_tpu_torch import sweep_cli
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
from slb2d_tpu_torch.parallel import mesh as tmesh
from slb2d_tpu_torch.parallel.spatial import M_FIELDS
from slb2d_tpu_torch.runtime.loop import Simulation

from torch_support import held_tensors

CPU = torch.device("cpu")
BASE = dict(display=4, E_dc=1.0, E_omega=2.0, omega=150.0, mu=1.0,
            alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
            B=0.1, t_start=0.01, g_grid=24, dt=1e-3, quiet=True)
E_DCS = np.linspace(0.25, 2.0, 4)
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-4,
                                                         atol=2e-5)}
STATE = ("state_a", "state_b", "state_a_hs", "state_b_hs",
         "state_hs_edge_a", "state_hs_edge_b", "state_t", "state_step")


def mesh(sweep, space):
    return make_mesh((sweep, space), ("sweep", "space"),
                     devices=[CPU] * (sweep * space))


def combined(cfg, params, sweep=2, space=2, **kw):
    return ParameterSweep(cfg, params, mesh=mesh(sweep, space),
                          space_axis="space", **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's combined sweep on one (2, 4) mesh, per dtype: (table,
    captures)."""
    m = jax_mesh((2, 4), ("sweep", "space"))
    out = {}
    for dtype in ("f64", "f32"):
        sw = JSweep(JConfig(**BASE, dtype=dtype), {"E_dc": E_DCS}, mesh=m,
                    space_axis="space")
        res = sw.run(capture_state=True)
        out[dtype] = ({k: np.asarray(v) for k, v in res.items()},
                      sw.final_ab)
    return out


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_combined_sweep_matches_jax(jax_runs, dtype):
    ref, ref_ab = jax_runs[dtype]
    sw = combined(SimConfig(**BASE, impl="torch", dtype=dtype),
                  {"E_dc": E_DCS}, sweep=2, space=4, capture_state=True)
    assert sw.engine == "torch" and len(sw.blocks) == 2
    assert all(sub.layout.S == 4 for _, sub in sw.blocks)
    res = sw.run()
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], err_msg=k, **TOL[dtype])
    for got, want in zip(sw.final_ab, ref_ab):
        np.testing.assert_allclose(got, np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("params", [
    {"E_dc": E_DCS},                                # 2 points a block
    {"E_dc": np.linspace(0.25, 2.0, 7)},            # ragged: 4 + 3
    {"omega": np.array([140.0, 150.0, 170.0, 145.0, 160.0]),
     "B": np.array([0.1, 0.2, 0.0, 0.1, 0.15])},    # per-point windows
    {"mu": np.array([0.9, 1.0, 1.1])},              # a0 per point
], ids=["even", "ragged", "omega", "mu"])
def test_combined_sweep_bit_for_bit_with_one_device(tmp_path, params):
    """The whole state (the final checkpoint) and each point's capture
    bit for bit with the one-device sweep; the table at 1e-12 (f64)."""
    cfg = SimConfig(**BASE, impl="torch", dtype="f64")
    one = ParameterSweep(cfg, params, device=CPU, capture_state=True)
    ref = one.run(checkpoint=str(tmp_path / "one.npz"))
    sw = combined(cfg, params, capture_state=True)
    assert sw.n_steps == one.n_steps
    res = sw.run(checkpoint=str(tmp_path / "comb.npz"))
    a, b = np.load(tmp_path / "comb.npz"), np.load(tmp_path / "one.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in STATE + ("cap_a", "cap_b"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for got, want in zip(sw.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], err_msg=k, **TOL["f64"])


class Stop(Exception):
    pass


@pytest.mark.parametrize("first,then", [("combined", "one"),
                                        ("one", "combined")])
def test_checkpoint_resumes_across_layouts(tmp_path, monkeypatch, first,
                                           then):
    """A sweep stopped at its first mid-run checkpoint on one layout and
    resumed on the other ends bit for bit as an unbroken run (its
    state, captures and table)."""
    cfg = SimConfig(**BASE, impl="torch", dtype="f64")
    params = {"E_dc": np.linspace(0.25, 2.0, 3)}
    make = {"combined": lambda: combined(cfg, params, capture_state=True),
            "one": lambda: ParameterSweep(cfg, params, device=CPU,
                                          capture_state=True)}
    whole = make["one"]()
    ref = whole.run(checkpoint=str(tmp_path / "whole.npz"))
    orig = ParameterSweep._save_checkpoint

    def save_once(self, path, states, cap, done):
        orig(self, path, states, cap, done)
        if done < self.n_steps:
            raise Stop

    ck = str(tmp_path / "ck.npz")
    with monkeypatch.context() as mp:
        mp.setattr(ParameterSweep, "_save_checkpoint", save_once)
        with pytest.raises(Stop):
            make[first]().run(checkpoint=ck, checkpoint_every=20)
    assert int(np.load(ck)["done"]) == 20
    sw = make[then]()
    res = sw.run(checkpoint=ck, resume=ck)
    a, b = np.load(ck), np.load(tmp_path / "whole.npz")
    for k in STATE + ("cap_a", "cap_b"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for got, want in zip(sw.final_ab, whole.final_ab):
        np.testing.assert_array_equal(got, want)
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], err_msg=k, **TOL["f64"])


def test_sweep_cli_shards(tmp_path, monkeypatch, capsys):
    """shards=2 on one CPU device: JAX's message, exit 1.  On four local
    devices (CPU slots standing in for cards) a (2, 2) mesh, whose table
    is the one-device table at 1e-12."""
    args = ["E_dc=1.0", "E_omega=2.0", "omega=150.0", "mu=1.0",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10.0",
            "PhiYmax=10.0", "B=0.1", "t-max=0.01", "g-grid=24", "dt=0.001",
            "dtype=f64", "impl=torch", "device=cpu",
            "sweep:E_dc=0.25,2.0,3"]
    monkeypatch.chdir(tmp_path)
    assert sweep_cli.main(args + ["shards=2", "o=sh.txt"]) == 1
    assert ("shards=2 does not divide the 1 available devices."
            in capsys.readouterr().err)
    assert sweep_cli.main(args + ["o=one.txt"]) == 0
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda cfg=None, device=None: [CPU] * 4)
    assert sweep_cli.main(args + ["shards=2", "o=sh.txt"]) == 0
    assert ("on 4 of 4 device(s), blocks of 2 points, phi_y grid over 2 "
            "shards [torch engine]" in capsys.readouterr().err)
    sh, one = (np.loadtxt(tmp_path / f) for f in ("sh.txt", "one.txt"))
    assert sh.shape == one.shape == (3, 15)
    np.testing.assert_allclose(sh, one, **TOL["f64"])


@pytest.mark.parametrize("impl", ["cuda", "stream"])
def test_kernel_impls_refuse_the_combined_layout(impl):
    """No kernel runs the combined layout: impl=cuda and impl=stream
    raise, naming it and impl=torch|auto (the port's impl=cuda never
    gives way to the batched engine)."""
    cfg = SimConfig(**BASE, impl=impl, dtype="f32")
    with pytest.raises(ValueError, match="combined sweep x space layout.*"
                                         "impl=torch\\|auto"):
        combined(cfg, {"E_dc": E_DCS})


@pytest.mark.parametrize("impl", ["torch", "stream"])
def test_sharded_run_holds_no_whole_grid_constant(impl):
    """With shards=2 no tensor of the run or its runner is a whole grid
    wide: the m-indexed constants sit on the slots as L-column slices and
    the whole grid's only as the model's host arrays (the run's outputs
    are unchanged: tests/test_torch_spatial.py and
    test_torch_stream_shard.py hold them)."""
    cfg = SimConfig(**BASE, impl=impl, dtype="f32", shards=2)
    sim = Simulation(cfg, mesh=make_mesh((2,), ("space",),
                                         devices=[CPU] * 2))
    sim.run()
    MP, L = sim.model.MP, sim.layout.L
    wide = [(p, tuple(t.shape)) for p, t in held_tensors(sim)
            if t.dim() and t.shape[-1] == MP]
    assert not wide, wide
    for f in M_FIELDS:
        assert [t.shape[-1] for t in getattr(sim.c, f).items] == [L, L], f
    if impl == "stream":
        assert sim._runner.launches == 0          # the plain version ran


def test_combined_sweep_holds_no_whole_grid_constant():
    cfg = SimConfig(**BASE, impl="torch", dtype="f32")
    sw = combined(cfg, {"mu": np.array([0.9, 1.0, 1.1])},
                  capture_state=True)
    sw.run()
    MP = sw.base.MP
    wide = [(p, tuple(t.shape)) for p, t in held_tensors(sw)
            if t.dim() and t.shape[-1] == MP]
    assert not wide, wide


def test_rows_across_some_processes_get_their_group(monkeypatch):
    """A combined block whose slots span more than one process and fewer
    than all (4 hosts of one card, shards=2) needs a process group of its
    processes: _row_groups makes one for each such row, in row order on
    every process, and a SpaceLayout over such a row refuses to run
    without it (its sums would wait for every process)."""
    from slb2d_tpu_torch.parallel import spatial
    from slb2d_tpu_torch.parallel import sweep as tsweep
    from slb2d_tpu_torch.parallel.mesh import Slot
    made = []
    monkeypatch.setattr(tmesh, "process_count", lambda: 3)
    monkeypatch.setattr(spatial, "process_count", lambda: 3)
    monkeypatch.setattr(torch.distributed, "new_group",
                        lambda ranks: made.append(ranks) or f"group{ranks}")
    rows = [[Slot(0, CPU), Slot(1, CPU)], [Slot(2, CPU), Slot(2, CPU)],
            [Slot(1, CPU), Slot(2, CPU)], [Slot(0, CPU), Slot(1, CPU),
                                           Slot(2, CPU)]]
    assert tsweep._row_groups(rows) == {0: "group[0, 1]", 2: "group[1, 2]"}
    assert made == [[0, 1], [1, 2]]
    with pytest.raises(ValueError, match="need their process group"):
        spatial.SpaceLayout(rows[0], 128)
    lay = spatial.SpaceLayout(rows[0], 128, group="group[0, 1]")
    assert lay.n_per_rank == [1, 1] and lay.local == [0]
    assert spatial.SpaceLayout(rows[3], 384).group is None
