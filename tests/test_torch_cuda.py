"""The CUDA kernels on a card, against their plain PyTorch versions.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sweep_kernel_matches_plain(card, dtype):
    """The sweep kernel on the ragged 6-point grid (a dc-only point, mu
    swept), 60 steps in two chunks, as chip_smoke.py's sweep-kernel phase
    checks it (f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7, edges bit for bit,
    the dc-only point's av exactly 0)."""
    import chip_smoke
    chip_smoke.check_sweep_kernel_vs_plain("ragged", dtype, n_steps=60)


@pytest.mark.cuda
def test_sweep_runner_validates_before_launch(card):
    import chip_smoke
    sweep, runner = chip_smoke._sweep_setup("ragged", "f32")
    state = sweep._initial_states()
    bad = state.replace(av=state.av.t().contiguous().t())   # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(bad, 4)
    assert runner.launches == 0
    out = runner.advance(state, 6)
    torch.cuda.synchronize()
    assert runner.launches == 1 and int(out.step[0]) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_omega_kernel_matches_plain(card, dtype):
    """The per-omega sweep kernel on the ragged 5-point omega grid (a
    dc-only point, distinct windows) over the whole sweep, 151 steps then
    the rest from parity 1, as chip_smoke.py's omega-kernel phase checks
    it (f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7 on states, av, the
    loop-exit captures, which all fire, and the frames arrays; edges bit
    for bit; the dc-only point's av exactly 0)."""
    import chip_smoke
    chip_smoke.check_omega_kernel_vs_plain("omega_ragged", dtype)


@pytest.mark.cuda
def test_omega_runner_validates_before_launch(card):
    import chip_smoke
    sweep, runner = chip_smoke._sweep_setup("omega_ragged", "f32")
    assert runner.per_omega
    state = sweep._initial_states()
    cap = chip_smoke._zero_cap(sweep)
    bad = state.replace(b=state.b.transpose(1, 2).contiguous()
                        .transpose(1, 2))                # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(bad, 4, cap=cap)
    assert runner.launches == 0
    out, cap = runner.advance(state, 6, cap=cap)
    torch.cuda.synchronize()
    assert runner.launches == 1 and int(out.step[0]) == 6
    assert set(cap) == {"v_dr", "v_y", "m_x", "norm"}
    frames = chip_smoke._zero_cap(sweep, frames=True)
    del frames["b"]
    with pytest.raises(ValueError, match="both a and b"):
        runner.advance(out, 4, cap=frames)
    assert runner.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("grid", [(8, 64), (18, 300)])
def test_stream_kernel_matches_plain(card, dtype, grid):
    """The temporal-tiling kernel against its plain version, K+3 steps
    then 5 from parity 1 with display-77 records, as chip_smoke.py's
    stream-kernel phase checks it (state and edges bit for bit; av and
    records at f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7)."""
    import chip_smoke
    chip_smoke.check_stream_vs_plain(
        dict(n_harmonics=grid[0], g_grid=grid[1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_stream_kernel_matches_step_kernel(card, dtype):
    """B2 and B1 from one state over 203 steps: state and edges bit for
    bit, av and records at the sums' order tolerance."""
    import chip_smoke
    chip_smoke.check_stream_vs_b1(dict(n_harmonics=8, g_grid=300), dtype)


@pytest.mark.cuda
def test_stream_runner_validates_before_launch(card):
    from slb2d_tpu_torch.ops import stencil
    import chip_smoke
    model, c, xs, runner = chip_smoke._stream_runner(chip_smoke.SMALL,
                                                     "f32")
    state = stencil.bootstrap_state(c, model)
    bad = state.replace(b=state.b.t().contiguous().t())   # strided view
    with pytest.raises(ValueError, match="contiguous"):
        runner(bad, 4)
    with pytest.raises(ValueError, match="emit_idx"):
        runner.run_xs(state, xs, 0, emit_idx=(5, 2))
    assert runner.launches == 0
    out = runner(state, 11)
    torch.cuda.synchronize()
    assert runner.launches == 2 * -(-11 // runner.geom.K)
    assert int(out.step) == 11
    assert out.a.data_ptr() == state.a.data_ptr()   # updated in place


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_points", [("lanes3", 16),
                                              ("omega_ragged", 2)])
def test_lanes_kernel_matches_plain(card, shape, max_points):
    """The lane-packed kernel against its plain version over the whole
    sweep, split across calls at step 151 (the second call from parity 1),
    as chip_smoke.py's lanes-kernel phase checks it (f32 rtol 1e-4 atol
    1e-7 where not bit for bit; av counts equal to the schedule; every
    capture fired; the dc-only point's av exactly 0).  max_points=2 pads
    the ragged grid's last chunk with a dead lane."""
    import chip_smoke
    chip_smoke.check_lanes_vs_plain(shape, max_points)


@pytest.mark.cuda
def test_lanes_runner_validates_before_launch(card):
    import chip_smoke
    sweep, runner = chip_smoke._lanes_runner("lanes3")
    st = runner.start(0)
    bad = st.__class__(**{**vars(st), "cap": st.cap.t().contiguous().t()})
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(0, bad, 4)
    assert runner.launches == 0
    out = runner.advance(0, st, 6)
    torch.cuda.synchronize()
    assert runner.launches == 2 * 6 and out.a.data_ptr() == st.a.data_ptr()
    assert bool(torch.all(out.av[0, :sweep.base.MP] == 0))   # t < t_start
