"""The CUDA step kernel on a card, against its plain PyTorch version.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports neither jax nor the JAX package, so it also runs on a machine
without them (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kernel_matches_plain(card, dtype):
    """200 steps in two chunks with display-77 records, as chip_smoke.py's
    kernel phase checks them (f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7,
    edges bit for bit)."""
    import chip_smoke
    chip_smoke.check_kernel_vs_plain(chip_smoke.SMALL, dtype, n_steps=200)


@pytest.mark.cuda
def test_runner_validates_before_launch(card):
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    import chip_smoke
    cfg = SimConfig(display=4, t_start=0.05, **chip_smoke.PHYS,
                    **chip_smoke.SMALL)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model, card)
    runner = stepper_cuda.make_cuda_runner(c, model)
    state = stencil.bootstrap_state(c, model)
    bad = state.replace(a=state.a.t().contiguous().t())   # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner(bad, 4)
    with pytest.raises(ValueError, match="emit_idx"):
        runner.run_xs(state, {k: v for k, v in chip_smoke._setup(
            chip_smoke.SMALL, "f32", card)[2].items()}, 0, emit_idx=(5, 2))
    assert runner.launches == 0
    out = runner(state, 6)
    torch.cuda.synchronize()
    assert runner.launches == 3 * 6 and int(out.step) == 6
