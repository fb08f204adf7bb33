"""The port's meshes (slb2d_tpu_torch/parallel/mesh.py) against the JAX
package's (slb2d_tpu/parallel/mesh.py) on the 8-device CPU mesh that
tests/conftest.py gives JAX: the same shapes, axis names and errors, and
default_split alike; the port's slots repeat the CPU where JAX has
virtual devices.  Meshes across processes are held by
tests/test_torch_multihost.py."""

import pytest
import torch

import jax

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.parallel import mesh as jmesh

from slb2d_tpu_torch import parallel
from slb2d_tpu_torch.parallel import mesh as tmesh
from slb2d_tpu_torch.config import SimConfig

CPU = torch.device("cpu")


@pytest.mark.parametrize("shape,names", [
    (None, ("sweep", "space")),
    ((8,), ("sweep",)),
    ((4, 2), ("sweep", "space")),
    ((2,), ("space",)),
    ((1, 4), ("sweep", "space")),
])
def test_make_mesh_matches_jax_shapes(shape, names):
    jm = jmesh.make_mesh(shape, names)
    tm = tmesh.make_mesh(shape, names, devices=[CPU] * len(jax.devices()))
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.slots.shape == jm.devices.shape
    assert all(s.rank == 0 and s.device == CPU for s in tm.slots.flat)
    assert parallel.make_mesh is tmesh.make_mesh


def test_make_mesh_too_few_devices_raises_as_jax():
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh((16,), ("sweep",))
    with pytest.raises(ValueError) as te:
        tmesh.make_mesh((16,), ("sweep",), devices=[CPU] * 8)
    assert str(te.value) == str(je.value)
    assert "needs 16 devices, have 8" in str(te.value)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12, 16, 32])
def test_default_split_matches_jax(n):
    assert tmesh.default_split(n) == jmesh.default_split(n)


def test_local_devices_and_axis_slots():
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
                    alpha=0.9495, n_harmonics=8, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=0.3, g_grid=24,
                    dt=1e-3, device="cpu")
    assert tmesh.local_devices(cfg) == [CPU]
    assert tmesh.local_devices(device="cpu") == [CPU]
    m = tmesh.make_mesh(None, ("sweep",), cfg=cfg)
    assert m.shape == {"sweep": 1} and len(m.axis_slots("sweep")) == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh((2,), ("sweep",), cfg=cfg)
    m = tmesh.make_mesh(None, ("sweep",), devices=[CPU] * 3)
    assert m.shape == {"sweep": 3} and len(m.axis_slots("sweep")) == 3
    m = tmesh.make_mesh((2, 2), ("sweep", "space"), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="Mesh.grid"):
        m.axis_slots("space")
    flat = [id(s) for s in m.slots.reshape(-1)]
    for axes, rows in ((("sweep", "space"), [flat[:2], flat[2:]]),
                       (("space", "sweep"), [flat[0::2], flat[1::2]])):
        assert [[id(s) for s in r] for r in m.grid(*axes)] == rows
    assert tmesh.process_index() == 0 and tmesh.process_count() == 1


def test_init_distributed_without_a_launcher_returns_false(monkeypatch):
    for k in ("SLB2D_COORD", "SLB2D_NPROCS", "SLB2D_PROC_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
