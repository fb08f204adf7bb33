"""ParameterSweep over a "sweep" mesh (slb2d_tpu_torch/parallel/sweep.py):
each slot runs a contiguous block of ceil(B / S) points on its own device.

Against the same sweep on one device, bit for bit (every point's work is
the same arithmetic whichever block holds it), ragged batches included;
against the JAX package's mesh-sharded sweep (the run of
tests/test_parallel.py's test_sweep_sharded_over_mesh_matches_unsharded),
in f64 at 1e-12 and in f32 at tests/test_torch_sweep.py's envelope (rtol
2e-4, atol 2e-5: XLA contracts multiply-adds on the CPU, the port does
not); checkpoints across meshes; and the sweep CLI, which puts every
visible device on the "sweep" axis (three CPU slots stand in for three
cards).  A ragged batch is a deliberate difference: the JAX package
replicates one it cannot split evenly, the port leaves the last slots
fewer points."""

import numpy as np
import pytest
import torch

import jax

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.parallel import ParameterSweep as JSweep
from slb2d_tpu.parallel import make_mesh as jax_mesh

from slb2d_tpu_torch import sweep_cli
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
from slb2d_tpu_torch.parallel import mesh as tmesh

BASE = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
            alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
            B=0.1, t_start=0.3, g_grid=24, dt=1e-3, quiet=True)
CPU = torch.device("cpu")
# the bit-for-bit runs: 260 steps (omega=30)
SHORT = dict(BASE, omega=30.0, t_start=0.05)


def mesh(S):
    return make_mesh((S,), ("sweep",), devices=[CPU] * S)


def assert_same(res, ref):
    assert res.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("params", [
    {"E_dc": np.linspace(0.25, 2.0, 8)},            # 8 over S: even
    {"E_dc": np.linspace(0.25, 2.0, 7)},            # ragged
    {"omega": np.array([28.0, 30.0, 34.0, 29.0, 31.0]),
     "B": np.array([0.1, 0.2, 0.0, 0.1, 0.15])},    # per-point windows
    {"mu": np.array([0.9, 1.0, 1.1])},              # a0 per point; empty
])
def test_mesh_sweep_equals_one_device_bit_for_bit(S, params):
    cfg = SimConfig(**SHORT, impl="torch", dtype="f64")
    one = ParameterSweep(cfg, params, device=CPU, capture_state=True)
    ref = one.run()
    sw = ParameterSweep(cfg, params, capture_state=True, mesh=mesh(S))
    assert sw.n_steps == one.n_steps
    per = -(-sw.B // S)
    assert sw.bounds == [(min(i * per, sw.B), min((i + 1) * per, sw.B))
                         for i in range(S)]
    assert_same(sw.run(), ref)
    for got, want in zip(sw.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,tol", [
    ("f32", dict(rtol=2e-4, atol=2e-5)),
    ("f64", dict(rtol=1e-12, atol=1e-15))])
def test_mesh_sweep_matches_jax_mesh_sweep(dtype, tol):
    e_dcs = np.linspace(0.25, 2.0, 8)
    ref = JSweep(JConfig(**BASE, dtype=dtype), {"E_dc": e_dcs},
                 mesh=jax_mesh((8,), ("sweep",))).run()
    res = ParameterSweep(SimConfig(**BASE, impl="torch", dtype=dtype),
                         {"E_dc": e_dcs}, mesh=mesh(4)).run()
    for k in ref:
        np.testing.assert_allclose(res[k], np.asarray(ref[k]), err_msg=k,
                                   **tol)


def test_mesh_checkpoint_resumes_on_another_mesh(tmp_path):
    """A checkpoint written on 4 slots resumes on 2 and on one device,
    and equals the uninterrupted run."""
    cfg = SimConfig(**SHORT, impl="torch", dtype="f64")
    params = {"E_dc": np.linspace(0.25, 2.0, 6)}
    ref = ParameterSweep(cfg, params, device=CPU).run()
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass
    orig = ParameterSweep._save_checkpoint

    def save_once(self, path, states, cap, done):
        orig(self, path, states, cap, done)
        if done < self.n_steps:
            raise Stop
    ParameterSweep._save_checkpoint = save_once
    try:
        with pytest.raises(Stop):
            ParameterSweep(cfg, params, mesh=mesh(4)).run(
                checkpoint=ck, checkpoint_every=100)
    finally:
        ParameterSweep._save_checkpoint = orig
    assert_same(ParameterSweep(cfg, params, mesh=mesh(2)).run(resume=ck),
                ref)
    assert_same(ParameterSweep(cfg, params, device=CPU).run(resume=ck), ref)


def test_sweep_cli_on_a_mesh(tmp_path, monkeypatch, capsys):
    args = ["E_dc=1.0", "E_omega=2.0", "omega=30.0", "mu=1.0",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10.0",
            "PhiYmax=10.0", "B=0.1", "t-max=0.05", "g-grid=24", "dt=0.001",
            "dtype=f64", "impl=torch", "device=cpu",
            "sweep:E_dc=0.25,2.0,5", f"frames-dir={tmp_path / 'fr'}"]
    monkeypatch.chdir(tmp_path)
    assert sweep_cli.main(args + ["o=one.txt"]) == 0
    one_err = capsys.readouterr().err
    assert "on cpu [torch engine]" in one_err
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda cfg=None, device=None: [CPU] * 3)
    assert sweep_cli.main(args + ["o=mesh.txt"]) == 0
    assert ("on 3 of 3 device(s), blocks of 2 points [torch engine]"
            in capsys.readouterr().err)
    one = (tmp_path / "one.txt").read_text()
    assert (tmp_path / "mesh.txt").read_text() == one
    assert len([l for l in one.splitlines() if not l.startswith("#")]) == 5
    assert len(list((tmp_path / "fr" / "grid00").glob("point*.data"))) == 5
