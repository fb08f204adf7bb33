"""The port's device frame reconstruction (ops/frames.py
reconstruct_on_device) on CPU tensors, its plain version, against the JAX
package's on the CPU: F and norm_sum in f32 at rtol 1e-5 with atol 1e-6;
in f64 against the host float64 frame and norm at rtol 1e-12 with atol
1e-15; the float32 matmul precision settings restored after the call;
and the driver's choice of the device path (every dtype on a card)."""

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import frames as jframes

from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import frames as tframes
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import COMMON

CPU = torch.device("cpu")


def _pair(N, M, dtype="f32"):
    kw = {**COMMON, "display": 7, "n_harmonics": N, "g_grid": M,
          "t_start": 0.2, "dtype": dtype}
    return (jframes.FrameReconstructor(JModel(JConfig(**kw))),
            tframes.FrameReconstructor(SuperlatticeModel(SimConfig(**kw))))


def _state(model, seed):
    """Random (a, b) of the model's shape, a's row 0 near a0's."""
    rng = np.random.default_rng(seed)
    D = model.np_dtype
    a = (rng.standard_normal((model.NHP, model.MP)) * 0.05).astype(D)
    a[0] += model.a0[0]
    b = (rng.standard_normal((model.NHP, model.MP)) * 0.05).astype(D)
    return a, b


@pytest.mark.parametrize("N,M,m_lo,m_hi", [
    (8, 24, 1, 26),          # a frame's m = 1..M+1 at the tiny shape
    (20, 200, 1, 202),       # BASELINE #1's grid
    (20, 1000, 1, 1002),     # BASELINE #3's grid
    (13, 300, 5, 77),        # another slice
])
def test_reconstruct_on_device_matches_jax(N, M, m_lo, m_hi):
    jr, tr = _pair(N, M)
    a, b = _state(tr.model, N * 1000 + M)
    jF, jn = jr.reconstruct_on_device(a, b, m_lo, m_hi)
    tF, tn = tr.reconstruct_on_device(torch.from_numpy(a),
                                      torch.from_numpy(b), m_lo, m_hi)
    assert tF.dtype == torch.float32 and tn.dtype == torch.float32
    assert tuple(tF.shape) == jF.shape == (len(tr.phi_x), m_hi - m_lo)
    assert tn.shape == () and float(tF.min()) >= 0
    np.testing.assert_allclose(tF.numpy(), jF, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5, atol=1e-6)
    # and the host float64 frame it stands in for, at the same tolerance
    np.testing.assert_allclose(tF.numpy(), tr.reconstruct(a, b, m_lo, m_hi),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,M,m_lo,m_hi", [
    (8, 24, 1, 26), (20, 200, 1, 202), (20, 1000, 1, 1002),
    (13, 300, 5, 77)])
def test_reconstruct_on_device_f64_matches_host_frame(N, M, m_lo, m_hi):
    """Float64 tensors take float64 tables and products: F against the
    host float64 frame, norm_sum scaled as the driver's finish scales it
    against the host norm (observables.eval_norm), rtol 1e-12 atol
    1e-15."""
    from slb2d_tpu_torch.ops import observables
    _, tr = _pair(N, M, "f64")
    a, b = _state(tr.model, N * 1000 + M + 1)
    F, ns = tr.reconstruct_on_device(torch.from_numpy(a),
                                     torch.from_numpy(b), m_lo, m_hi)
    assert F.dtype == torch.float64 and ns.dtype == torch.float64
    assert float(F.min()) >= 0
    np.testing.assert_allclose(F.numpy(), tr.reconstruct(a, b, m_lo, m_hi),
                               rtol=1e-12, atol=1e-15)
    norm = float(ns) * 2 * np.pi * np.sqrt(tr.model.alpha)
    np.testing.assert_allclose(norm, observables.eval_norm(tr.model, a),
                               rtol=1e-12, atol=1e-15)


def test_device_frame_is_a_fresh_tensor():
    """F and norm_sum do not alias the state: a kernel that updates a and
    b in place after the call leaves them as they were."""
    _, tr = _pair(8, 24)
    a, b = (torch.from_numpy(x) for x in _state(tr.model, 3))
    F, n = tr.reconstruct_on_device(a, b, 1, 26)
    F0, n0 = F.clone(), n.clone()
    a.mul_(3.0)
    b.add_(1.0)
    assert torch.equal(F, F0) and torch.equal(n, n0)


@pytest.mark.parametrize("setting", ["default", "high", "allow_tf32"])
def test_precision_settings_are_restored(setting):
    """Inside the call TF32 is off and the float32 matmul precision is
    "highest"; after it the caller's settings are back."""
    def current():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())

    saved = current()
    try:
        if setting == "high":
            torch.set_float32_matmul_precision("high")
        elif setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        before = current()
        inside = []
        with tframes.full_f32_matmul():
            inside.append(current())
        assert inside == [(False, "highest")]
        assert current() == before
        _, tr = _pair(8, 24)
        a, b = (torch.from_numpy(x) for x in _state(tr.model, 5))
        tr.reconstruct_on_device(a, b, 1, 26)
        assert current() == before
    finally:
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]


def test_settings_are_restored_when_the_call_raises():
    _, tr = _pair(8, 24)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    with pytest.raises(RuntimeError):
        tr.reconstruct_on_device(torch.zeros(3, 5), torch.zeros(3, 5), 1, 4)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before


@pytest.mark.parametrize("dtype,device,expected", [
    ("f32", "cuda:0", True), ("f64", "cuda:0", True),
    ("f32", "cpu", False), ("f64", "cpu", False)])
def test_driver_takes_the_device_path_for_f32_on_a_card(dtype, device,
                                                        expected):
    """Simulation._device_frames: on a CUDA device, float32 and float64
    (the JAX package, without float64 products on a TPU: float32 only);
    checked without building the device constants."""
    sim = Simulation.__new__(Simulation)
    sim.model = SuperlatticeModel(SimConfig(**{**COMMON, "display": 7,
                                               "n_harmonics": 8,
                                               "g_grid": 24, "t_start": 0.2,
                                               "dtype": dtype}))
    sim.device = torch.device(device)
    assert sim._device_frames() is expected


def test_host_frame_parts_on_the_cpu():
    """On the CPU the driver's frames take the host float64 path: F is a
    numpy array equal to FrameReconstructor.reconstruct of the state, and
    finish returns the host norm."""
    cfg = SimConfig(**{**COMMON, "display": 7, "n_harmonics": 8,
                       "g_grid": 24, "t_start": 0.2, "dtype": "f32"},
                    impl="torch")
    sim = Simulation(cfg, device=CPU)
    F, ns, finish = sim._frame_parts()
    a, b = sim._host_ab()
    assert ns is None and isinstance(F, np.ndarray)
    np.testing.assert_array_equal(
        F, sim._get_recon().reconstruct(a, b, 1, sim.model.M + 2))
    from slb2d_tpu_torch.ops import observables
    assert finish(None) == observables.eval_norm(sim.model, a)
