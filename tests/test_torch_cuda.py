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
@pytest.mark.parametrize("form", ["resident", "per-half-step"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kernel_matches_plain(card, dtype, form):
    """200 steps in two chunks with display-77 records, as chip_smoke.py's
    kernel phase checks them, in each form of B1 (state and edges bit for
    bit; av and records at f64 rtol 1e-12, f32 rtol 1e-4 atol 1e-7)."""
    import chip_smoke
    _, runner = chip_smoke.check_kernel_vs_plain(chip_smoke.SMALL, dtype,
                                                 n_steps=200, form=form)
    assert runner.form == form


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
    for form, per_run in (("resident", 1), ("per-half-step", 3 * 6)):
        runner = stepper_cuda.make_cuda_runner(c, model, form=form)
        state = stencil.bootstrap_state(c, model)
        bad = state.replace(a=state.a.t().contiguous().t())  # strided view
        with pytest.raises(ValueError, match="contiguous"):
            runner(bad, 4)
        with pytest.raises(ValueError, match="emit_idx"):
            runner.run_xs(state, {k: v for k, v in chip_smoke._setup(
                chip_smoke.SMALL, "f32", card)[2].items()}, 0,
                emit_idx=(5, 2))
        assert runner.launches == 0
        out = runner(state, 6)
        torch.cuda.synchronize()
        assert runner.launches == per_run and int(out.step) == 6
        assert out.a.data_ptr() == state.a.data_ptr()   # updated in place


# B1's resident form at N=8 M=64, BASELINE #4 (f32, f64), the wide grid
# and the tall grid (f32)
RESIDENT_CASES = [("N8M64", "f32", 200), ("N8M64", "f64", 200),
                  ("BASELINE4", "f32", 101), ("BASELINE4", "f64", 101),
                  ("WIDE", "f32", 41), ("TALL", "f32", 41)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,n_steps", RESIDENT_CASES)
def test_resident_form_matches_plain(card, shape, dtype, n_steps):
    """The resident form against run_chunk_plain in two chunks (the
    second from parity 1) with display-77 records in both: state and
    edges bit for bit, av and records at chip_smoke.TOL; one launch a
    chunk."""
    import chip_smoke
    grid = {"N8M64": chip_smoke.SMALL}.get(shape) or getattr(chip_smoke,
                                                              shape)
    _, runner = chip_smoke.check_kernel_vs_plain(grid, dtype,
                                                 n_steps=n_steps,
                                                 form="resident")
    assert runner.form == "resident" and runner.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("grid", [(8, 300), (100, 4000)])
def test_resident_form_matches_per_half_step(card, dtype, grid):
    """B1's two forms over 203 steps from one state: state and edges bit
    for bit, av and records at the sums' order tolerance."""
    import chip_smoke
    chip_smoke.check_resident_vs_per_half_step(
        dict(n_harmonics=grid[0], g_grid=grid[1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("W,why", [(512, "cudaError_t"),
                                   (32, "do not all fit")])
def test_refused_resident_launch_leaves_the_state_untouched(card, W, why):
    """A band the kernel cannot hold (W=512 at the tall grid: 3.4 MB a
    block) and more bands than the card runs at once (W=32 at the wide
    grid: 376 bands): the launch is refused before anything runs, the
    runner raises, and the state, av and every launch count stay as they
    were."""
    import chip_smoke
    from slb2d_tpu_torch import tracing
    from slb2d_tpu_torch.ops import stencil, stepper_cuda
    shape = chip_smoke.TALL if W == 512 else chip_smoke.WIDE
    model, c, _ = chip_smoke._setup(shape, "f32", card)
    runner = stepper_cuda.make_cuda_runner(c, model, form="resident")
    runner.plan = stepper_cuda.ResidentPlan(
        W, -(-model.MP // W), stepper_cuda.resident_smem_bytes(
            model.NHP, W, model.np_dtype), stepper_cuda.resident_threads(W))
    state = stencil.bootstrap_state(c, model)
    before = state.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match=why):
        runner(state, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_resident_form_info_at_the_shapes(card):
    """What the resident form takes at its plans: the shared memory the
    plan computed, at most 64 registers a thread (1024 threads a block),
    and every band's block on the card at once."""
    import numpy as np
    from slb2d_tpu_torch.ops import stepper_cuda
    for NHP, MP, D in ((408, 4096, np.float32), (104, 12032, np.float32),
                       (104, 4096, np.float32), (104, 4096, np.float64)):
        plan = stepper_cuda.resident_plan(NHP, MP, D,
                                          stepper_cuda.card_sms(card))
        info = stepper_cuda.form_info(D, plan.W, NHP, MP)
        assert info["smem_bytes"] == plan.smem_bytes
        assert info["threads"] == plan.threads
        assert 0 < info["registers"] <= 64
        assert info["blocks_at_once"] >= plan.bands


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


def _cluster_cases():
    """(mode, dtype, shape, cluster size) for every cluster size that holds
    a point of the ragged grids (NHP=16, MP=128) and of their N=40 M=500
    versions (NHP=48, MP=512): pure arithmetic on the shapes, the same in
    every process."""
    import numpy as np
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    cases = []
    for mode in ("shared", "omega"):
        for dtype, D in (("f64", np.float64), ("f32", np.float32)):
            for shape, NHP, MP in (("ragged", 16, 128), ("ragged40", 48, 512)):
                for cs in ssc.CLUSTER_SIZES:
                    if ssc.cluster_smem_bytes(NHP, MP, D, cs) is not None:
                        cases.append((mode, dtype, shape, cs))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype,shape,cluster_size", _cluster_cases())
def test_sweep_cluster_form_matches_plain(card, mode, dtype, shape,
                                          cluster_size):
    """B3's cluster form at every cluster size that holds the point,
    against the plain version: the shared mode 60 steps in two chunks, the
    per-omega mode over the whole sweep with frames (151 steps, then the
    rest from parity 1); state, edges and frames bit for bit, av and
    captures at f64 rtol 1e-12 / f32 rtol 1e-4 atol 1e-7, the dc-only
    point's av exactly 0."""
    import chip_smoke
    if mode == "shared":
        _, runner = chip_smoke.check_sweep_kernel_vs_plain(
            shape, dtype, n_steps=60, cluster_size=cluster_size)
    else:
        *_, runner = chip_smoke.check_omega_kernel_vs_plain(
            "omega_" + shape, dtype, cluster_size=cluster_size)
    assert runner.form == "cluster" and runner.cluster_size == cluster_size
    assert runner.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sweep_streaming_form_matches_plain(card, dtype):
    """The streaming form, forced where a cluster would hold the point,
    passes the checks it passed as the only form: both modes on the ragged
    grids, state and edges bit for bit."""
    import chip_smoke
    _, runner = chip_smoke.check_sweep_kernel_vs_plain(
        "ragged", dtype, n_steps=60, cluster_size=0)
    *_, o_runner = chip_smoke.check_omega_kernel_vs_plain(
        "omega_ragged", dtype, cluster_size=0)
    assert runner.form == o_runner.form == "streaming"
    assert runner.cluster_size == o_runner.cluster_size == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged40", "omega_ragged40"])
def test_refused_cluster_launch_raises_before_any_state_changes(card,
                                                                 shape):
    """A cluster too small for the point: the runner refuses it at
    construction, and the kernel refuses the launch if it is asked for
    anyway; the state, the capture and every launch count stay as they
    were."""
    import chip_smoke
    from slb2d_tpu_torch import tracing
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    sweep, runner = chip_smoke._sweep_setup(shape, "f32")
    assert runner.form == "cluster" and runner.cluster_size == 2
    with pytest.raises(ValueError, match="cannot hold"):
        ssc.SweepStackRunner(sweep, cluster_size=1)
    runner.cluster_size = 1           # 393 KB a block: past any block
    state = sweep._initial_states()
    before = state.clone()
    cap = chip_smoke._zero_cap(sweep, frames=True) if runner.per_omega \
        else None
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        if cap is None:
            runner.advance(state, 8)
        else:
            runner.advance(state, 8, cap=cap)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert all(bool((v == 0).all()) for v in (cap or {}).values())
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_form_info_at_the_sweep_shape(card):
    """What the plan's forms take at N=40 M=500: the shared memory the
    plan computed, at most 64 registers a thread (1024 threads a block),
    and at least one cluster on the card."""
    import numpy as np
    from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
    for D in (np.float32, np.float64):
        cs, smem = ssc.cluster_plan(48, 512, D)
        for per_omega in (False, True):
            info = ssc.form_info(D, per_omega, cs, 48, 512)
            assert info["smem_bytes"] == smem
            assert 0 < info["registers"] <= 64
            assert info["active_clusters"] >= 1
            stream = ssc.form_info(D, per_omega, 0, 48, 512)
            assert stream["smem_bytes"] == 0 and stream["active_clusters"] > 0


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
@pytest.mark.parametrize("case", range(4))
def test_spill_form_matches_plain(card, case):
    """B2's spill form through forced plans (2 and 5 bands, every band
    spilling; M+1 in a slab at N=13 M=300) against its plain version,
    B1's run_chunk_plain, in two chunks with display-77 records, as
    chip_smoke.py checks it (state and edges bit for bit, av and records
    at chip_smoke.TOL; one launch a chunk)."""
    import chip_smoke
    name, shape, dtype, bands, R = chip_smoke.SPILL_FORCED[case]
    _, runner = chip_smoke.check_spill_vs_plain(
        shape, dtype, forced=(bands, R))
    assert runner.form == "spill" and runner.launches == 2
    assert (runner.plan.bands, runner.plan.R) == (bands, R)


@pytest.mark.cuda
def test_spill_form_at_its_own_shape(card):
    """N=100 M=20000 f32, where impl=cuda runs the spill form: against
    run_chunk_plain over 61 steps in two chunks (the averaging window
    opens at step 50), and against the tiling
    form and B1's per-half-step form over 203 steps, state bit for bit."""
    import chip_smoke
    _, runner = chip_smoke.check_spill_vs_plain(chip_smoke.B2_OWN, "f32",
                                                n_steps=61)
    assert runner.plan.R == 128 and runner.plan.S == 25
    chip_smoke.check_stream_forms(chip_smoke.B2_OWN)


@pytest.mark.cuda
def test_refused_spill_launch_leaves_the_state_untouched(card):
    """More bands than the card runs at once (a forced plan of 400 bands
    at N=100 M=20000): the launch is refused before anything runs, the
    runner raises, and the state, av and every launch count stay as they
    were."""
    import chip_smoke
    from slb2d_tpu_torch import tracing
    from slb2d_tpu_torch.ops import stencil, stepper_stream_cuda as sst
    model, c, _ = chip_smoke._setup(chip_smoke.B2_OWN, "f32", card)
    plan = sst.spill_plan(model.NHP, model.MP, model.np_dtype, sms=400,
                          R=32)
    assert plan is not None
    runner = sst.make_stream_runner(c, model, form="spill", spill=plan)
    state = stencil.bootstrap_state(c, model)
    before = state.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="do not all fit"):
        runner(state, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_spill_form_info_at_its_shape(card):
    """What the spill form takes at its plan: the shared memory the plan
    computed, at most 64 registers a thread (1024 threads a block), every
    band's block on the card at once."""
    import numpy as np
    from slb2d_tpu_torch.ops import stepper_cuda, stepper_stream_cuda as sst
    plan = sst.spill_plan(104, 20096, np.float32,
                          stepper_cuda.card_sms(card))
    info = sst.spill_form_info(np.float32, plan, 104, 20096)
    assert info["smem_bytes"] == plan.smem_bytes
    assert info["threads"] == plan.threads == 1024
    assert 0 < info["registers"] <= 64
    assert info["blocks_at_once"] >= plan.bands


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size", [None, 0])
@pytest.mark.parametrize("shape,max_points,n_steps", [
    ("lanes3", 16, None), ("omega_ragged", 2, None),
    ("omega_ragged", 16, None), ("full", 16, 300), ("full", 64, 300)])
def test_lanes_kernel_matches_plain(card, shape, max_points, n_steps,
                                    cluster_size):
    """The lane-packed kernel in the form the plan picks (the cluster form
    at every one of these shapes) and in the streaming form against its
    plain version, split across calls at step 151 (the second call from
    parity 1), as chip_smoke.py's lanes-kernel phase checks it: state,
    per-lane rows and segment sums bit for bit; av counts equal to the
    schedule and every capture fired where run to the end; the dc-only
    point's av exactly 0.  max_points=2 pads the ragged grid's last chunk
    with a dead lane; the 64-point sweep runs 300 steps in chunks of 16
    and in one of 64."""
    import chip_smoke
    err, runner = chip_smoke.check_lanes_vs_plain(
        shape, max_points, n_steps, cluster_size=cluster_size)
    assert err == 0.0
    assert runner.form == ("cluster" if cluster_size is None
                           else "streaming")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_points", [("full", 16), ("full", 64),
                                              ("omega_ragged", 2)])
def test_lanes_cluster_form_matches_streaming_form(card, shape,
                                                   max_points):
    """The cluster form against the streaming form over the whole sweep
    from each chunk's bootstrap, one call per chunk: state, per-lane rows
    and segment sums bit for bit."""
    import chip_smoke
    runner = chip_smoke.check_lanes_forms(shape, max_points)
    assert runner.launches == len(runner.packs)


@pytest.mark.cuda
def test_forced_lanes_cluster_past_residency_raises_before_any_launch(card):
    """8 points at N=100 M=4000 (6.8 MB a point): the plan gives the
    streaming form, a forced cluster size is refused at construction,
    and a cluster form forced onto the runner anyway is refused by the
    kernel before launching; the state and every launch count stay as
    they were."""
    import chip_smoke
    from slb2d_tpu_torch import tracing
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    sweep, runner = chip_smoke._lanes_runner("wide8")
    assert runner.form == "streaming" and runner.cluster_size == 0
    for cs in slc.CLUSTER_SIZES:
        with pytest.raises(ValueError, match="cannot hold"):
            slc.make_sweep_lanes_runner(sweep, cluster_size=cs)
    runner.form, runner.cluster_size = "cluster", 8
    st = runner.start(0)
    before = st.clone()
    counts = tracing.counters()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        runner.advance(0, st, 8)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "av", "cap"):
        assert torch.equal(getattr(st, f), getattr(before, f)), f
    assert runner.launches == 0 and tracing.counters() == counts


@pytest.mark.cuda
def test_lanes_form_info_at_the_sweep_shape(card):
    """What the plan's forms take at N=40 M=500 in chunks of 16 and of 64,
    the plan made with the card's own clusters at once: the shared memory
    the plan computed, at most 64 registers a thread (1024 threads a
    block), and the whole chunk at once (one wave)."""
    from slb2d_tpu_torch.ops import sweep_lanes_cuda as slc
    for CB in (16, 64):
        cs, smem = slc.lanes_cluster_plan(
            48, 512, CB,
            lambda c: slc.form_info(c, 48, 512, CB)["active_clusters"])
        info = slc.form_info(cs, 48, 512, CB)
        assert info["smem_bytes"] == smem
        assert 0 < info["registers"] <= 64
        assert info["active_clusters"] >= CB
        stream = slc.form_info(0, 48, 512, CB)
        assert stream["smem_bytes"] == 0 and stream["active_clusters"] > 0


@pytest.mark.cuda
def test_lanes_runner_validates_before_launch(card):
    """Bad tensors are refused before any launch; a call of 6 steps is one
    launch of the cluster form, in place."""
    import chip_smoke
    sweep, runner = chip_smoke._lanes_runner("lanes3")
    assert runner.form == "cluster" and runner.cluster_size == 4
    st = runner.start(0)
    bad = st.__class__(**{**vars(st), "cap": st.cap.t().contiguous().t()})
    with pytest.raises(ValueError, match="contiguous"):
        runner.advance(0, bad, 4)
    assert runner.launches == 0
    out = runner.advance(0, st, 6)
    torch.cuda.synchronize()
    assert runner.launches == 1 and out.a.data_ptr() == st.a.data_ptr()
    assert bool(torch.all(out.av[0, :sweep.base.MP] == 0))   # t < t_start


@pytest.mark.cuda
@pytest.mark.parametrize("fma", [False, True])
def test_vpu_kernel_matches_plain(card, fma):
    """P1's chain kernel against its plain version, 2 turns at a ragged
    13 x 1000 cut of the probe's input (the tail masked) and at its full
    shape: bit for bit at every ILP, at two block sizes."""
    from slb2d_tpu_torch.perf import vpu_roofline as vr
    for shape in ((13, 1000), (vr.NHP, vr.MP)):
        coef, bias, x = vr.make_coeffs(shape)
        xt = torch.from_numpy(x).to(card)
        ref = vr.chain_plain(xt, coef, bias, 2, fma)
        for ilp in vr.ILPS:
            for block in (64, 256):
                got = vr.chain(xt, coef, bias, 2, fma=fma, ilp=ilp,
                               block=block)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (shape, ilp, block)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_roll_kernels_match_plain(card, axis):
    """P2's register and per-pass kernels against the plain version, 5
    and 100 passes (three halo refreshes at T=32), forms two and one, at
    the probe's shape and at 8 x 128: bit for bit; the inputs unchanged."""
    from slb2d_tpu_torch.perf import roll_cost_experiment as rce
    for shape in ((8, 128), (rce.NH, rce.MP)):
        x, y = (torch.from_numpy(a).to(card) for a in rce.make_inputs(shape))
        x0 = x.clone()
        for arrays in ([x, y], [torch.cat([x, y], 0)]):
            for k in (5, 100):
                ref = rce.roll_plain(arrays, axis, k)
                for fn in (rce.roll_registers, rce.roll_passes):
                    got = fn(arrays, axis, k)
                    torch.cuda.synchronize()
                    assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert torch.equal(x, x0)


@pytest.mark.cuda
@pytest.mark.parametrize("every", [None, 7, 1])
def test_register_halo_forms_match_plain(card, every):
    """roll_reg_halo along both axes of lines of 1024 and 2048, the halo
    refreshed every T passes, every 7 and every pass, 70 passes: bit for
    bit with the plain version."""
    from slb2d_tpu_torch.perf import roll_cost_experiment as rce
    x, y = (torch.from_numpy(a).to(card) for a in rce.make_inputs((4, 1024)))
    for axis, arrays in ((1, [x, y]), (0, [x.t().contiguous()]),
                         (1, [torch.cat([x, y], 1)])):
        ref = rce.roll_plain(arrays, axis, 70)
        got = rce.roll_registers(arrays, axis, 70, every=every)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), axis


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["resident", "per-half-step"])
@pytest.mark.parametrize("nhl", [16, 32])
def test_transposed_kernel_matches_b1_plain(card, nhl, form):
    """P3's kernel in each form against its plain version, B1's plain
    version (av off) transposed, 41 steps in two chunks (the second from
    parity 1), N=8 M=64: the state, transposed back, bit for bit; padding
    columns stay 0; one launch a chunk on the resident form, two a step on
    the other."""
    from slb2d_tpu_torch.perf import transposed_experiment as te
    model, c, tc, state0, xs = te.setup(card, 8, 64, nhl, 41)
    kern, plain = te.transpose_state(state0, nhl), te.transpose_state(
        state0, nhl)
    launches0 = te.launch_count
    for part, parity in ((xs[:21], 0), (xs[21:], 1)):
        kern = te.run_chunk(tc, kern, part, parity, form=form)
        plain = te.run_chunk_plain(tc, plain, part, parity)
    torch.cuda.synchronize()
    assert te.launch_count - launches0 == (2 if form == "resident"
                                           else 2 * 41)
    got, mine = (te.untranspose(s, model.NHP) for s in (kern, plain))
    for f, v in got.items():
        assert torch.equal(v, mine[f]), f
    assert bool((kern.a[:, model.NHP:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [None, 5])
def test_transposed_resident_form_matches_per_half_step(card, sms):
    """P3's resident form (its plan, and 5 bands of 26 rows) against its
    per-half-step form over 61 steps in two chunks at N=13 M=300 NHL=32:
    bit for bit."""
    from slb2d_tpu_torch.perf import transposed_experiment as te
    model, c, tc, state0, xs = te.setup(card, 13, 300, 32, 61)
    plan = (None if sms is None else
            te.resident_plan(model.NHP, model.MP, 32, sms))
    res, per = te.transpose_state(state0, 32), te.transpose_state(state0, 32)
    for part, parity in ((xs[:31], 0), (xs[31:], 1)):
        res = te.run_chunk(tc, res, part, parity, plan=plan)
        per = te.run_chunk(tc, per, part, parity, form="per-half-step")
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(res, f), getattr(per, f)), f


@pytest.mark.cuda
def test_transposed_resident_form_at_baseline4(card):
    """P3's resident form at BASELINE #4 (128 bands of 32 rows) against its
    plain version over 41 steps in two chunks: bit for bit; what it takes
    on the card holds the plan."""
    from slb2d_tpu_torch.perf import transposed_experiment as te
    model, c, tc, state0, xs = te.setup(card, steps=41)
    plan = te.resident_plan(model.NHP, model.MP, te.NHL, te.card_sms(card))
    kern, plain = te.transpose_state(state0), te.transpose_state(state0)
    for part, parity in ((xs[:21], 0), (xs[21:], 1)):
        kern = te.run_chunk(tc, kern, part, parity)
        plain = te.run_chunk_plain(tc, plain, part, parity)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    info = te.form_info(plan, model.NHP, model.MP)["resident"]
    assert info["smem_bytes"] == plan.smem_bytes
    assert info["threads"] == plan.threads
    assert info["blocks_at_once"] >= plan.bands and info["local_bytes"] == 0


@pytest.mark.cuda
def test_probe_wrappers_validate_before_launch(card):
    from slb2d_tpu_torch.perf import roll_cost_experiment as rce
    from slb2d_tpu_torch.perf import transposed_experiment as te
    from slb2d_tpu_torch.perf import vpu_roofline as vr
    coef, bias, x = vr.make_coeffs((4, 128))
    xt = torch.from_numpy(x).to(card)
    counts = (vr.launch_count, rce.register_launch_count,
              rce.pass_launch_count, te.launch_count)
    with pytest.raises(ValueError, match="float32"):
        vr.chain(xt.double(), coef, bias, 1)
    with pytest.raises(ValueError, match="ilp"):
        vr.chain(xt, coef, bias, 1, ilp=3)
    with pytest.raises(ValueError, match="lines of 100"):
        rce.roll_registers([torch.zeros((100, 8), device=card)], 0, 2)
    with pytest.raises(ValueError, match="every=40"):
        rce.roll_registers([torch.zeros((8, 1024), device=card)], 1, 2,
                           every=40)
    model, c, tc, state0, xs = te.setup(card, 8, 64, 16, 4)
    st = te.transpose_state(state0, 16)
    bad = te.TState(**{**vars(st), "b": st.b.t().contiguous().t()})
    for form in te.FORMS:
        with pytest.raises(ValueError, match="contiguous"):
            te.run_chunk(tc, bad, xs, 0, form=form)
    with pytest.raises(ValueError, match="form must be"):
        te.run_chunk(tc, st, xs, 0, form="banded")
    assert counts == (vr.launch_count, rce.register_launch_count,
                      rce.pass_launch_count, te.launch_count)


@pytest.mark.cuda
def test_refused_transposed_resident_launch_raises(card):
    """A plan the kernel cannot hold (rows past MAX_ROWS) and more bands
    than the card runs at once (2 rows a band at MP=4096: 2048 blocks of
    1024 threads at NHL=512): the launch is refused before anything runs,
    run_chunk raises, and the state and the launch counts stay as they
    were."""
    from slb2d_tpu_torch.perf import transposed_experiment as te
    nhl = 512
    model, c, tc, state0, xs = te.setup(card, 8, 4000, nhl, 4)
    st = te.transpose_state(state0, nhl)
    before = st.clone()
    counts = (te.launch_count, te.resident_launch_count)
    for R, why in ((514, "cudaError_t"), (2, "at once")):
        plan = te.TPlan(R, -(-model.MP // R),
                        te.resident_smem_bytes(nhl, R),
                        te.resident_threads(nhl, R))
        with pytest.raises(RuntimeError, match=why):
            te.run_chunk(tc, st, xs, 0, plan=plan)
    torch.cuda.synchronize()
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
        assert torch.equal(getattr(st, f), getattr(before, f)), f
    assert counts == (te.launch_count, te.resident_launch_count)


# the single-run driver's kernel engines in every form: (impl, the form
# chip_smoke.forced_form gives it; None is the plans' own choice)
DRIVER_FORMS = [("cuda", None), ("cuda", "per-half-step"),
                ("stream", None), ("stream", "spill")]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,form", DRIVER_FORMS)
def test_display_and_repl_goldens(card, tmp_path, impl, form):
    """Displays 3 and 7 (d3_tiny_*, d7_frame*) and the three recorded
    parameter-server sessions on each form, at tests/test_golden.py's
    tolerances with the headers byte for byte, as chip_smoke.py phase 24
    checks them; the form is checked to be the one that ran."""
    import chip_smoke
    errs = chip_smoke.displays_golden(impl, form, str(tmp_path))
    assert len(errs) == 9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_device_frame_matches_host_frame(card, dtype):
    """The device frame (in the state's dtype) against the host f64 frame
    of the same state at BASELINE #3's grid: f32 at the D7 envelope (rtol
    2e-4, atol 3e-6), f64 at rtol 1e-12 atol 1e-14."""
    import chip_smoke
    err, shape = chip_smoke.device_frame_vs_host(dtype, n_steps=300)
    assert shape == (629, 1001) and err < (3e-6 if dtype == "f32"
                                           else 1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(("cuda", None), ("cuda", "per-half-step")),
                                  (("stream", None), ("stream", "spill"))])
@pytest.mark.parametrize("display", [4, 9])
def test_mutations_and_resume_reach_every_form(card, tmp_path, pair,
                                               display):
    """A parameter-server session (display 4) or a display-9 run resumed
    from a checkpoint at an odd step on two forms: the states bit for bit
    (av at chip_smoke.TOL), the strobe files byte for byte."""
    import chip_smoke
    kw = dict(n_harmonics=8, g_grid=64, dtype="f32",
              **{**chip_smoke.PHYS, "omega": 50.0})
    out = []
    for impl, form in pair:
        d = str(tmp_path / f"{impl}-{form}")
        with chip_smoke.forced_form(form), chip_smoke.in_dir(d):
            if display == 4:
                sim = chip_smoke.run_sim(
                    dict(display=4, t_start=0.1, read_from="stdin", **kw),
                    impl, repl="E_dc 1.5 0.05\nomega 60 0.03\nexit\n")
            else:
                cfg = dict(display=9, t_start=0.05, **kw)
                from slb2d_tpu_torch.config import SimConfig
                from slb2d_tpu_torch.runtime.loop import Simulation
                first = Simulation(SimConfig(impl=impl, quiet=True,
                                             out_file="o.txt",
                                             checkpoint="ck.npz", **cfg),
                                   device=card)
                first.t_max = 0.4005
                first.run()
                assert first.steps_done % 2 == 1
                sim = chip_smoke.run_sim(dict(cfg, resume="ck.npz"), impl)
        assert (sim.engine_tag().split()[1] ==
                (form or ("resident" if impl == "cuda" else "tiling")))
        files = {f.name: f.read_bytes()
                 for f in (tmp_path / f"{impl}-{form}").iterdir()
                 if f.name.startswith("strobe")}
        out.append((sim, files))
    chip_smoke._state_equal(out[0][0].state, out[1][0].state,
                            f"{pair} display {display}")
    assert out[0][1] == out[1][1]
    assert len(out[0][1]) == (101 if display == 9 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dtype,grid", [("f64", (8, 64)), ("f32", (8, 64)),
                                        ("f32", (18, 300))])
def test_sharded_stream_matches_plain(card, dtype, grid, S):
    """B2's sharded form on S slots of cuda:0 against its plain version,
    K+3 steps then 5 from parity 1 with display-77 records (state and
    edges bit for bit, av and records at chip_smoke.TOL; S + 1 launches a
    round)."""
    import chip_smoke
    _, runner, _ = chip_smoke.check_shard_vs_plain(
        dict(n_harmonics=grid[0], g_grid=grid[1]), dtype, S)
    assert runner.form == "sharded" and runner.layout.S == S


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged", "omega_ragged"])
def test_sweep_mesh_on_two_slots_matches_one(card, shape):
    """A "sweep" mesh of two slots of cuda:0 (B3 a block) against the
    same sweep on the card alone: the table and the frames bit for bit."""
    import numpy as np
    import chip_smoke
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
    kw, params = chip_smoke.sweep_grid(shape)
    cfg = SimConfig(display=4, dtype="f32", impl="cuda", quiet=True, **kw)
    one = ParameterSweep(cfg, params, device=card, capture_state=True)
    ref = one.run()
    two = ParameterSweep(cfg, params, capture_state=True,
                         mesh=make_mesh((2,), ("sweep",),
                                        devices=[card] * 2))
    assert two.engine == "cuda"
    res = two.run()
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    for got, want in zip(two.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_dryrun_on_four_slots_of_the_card(card):
    """dryrun_multichip(4) on four slots of cuda:0: its six checks pass
    and B2's sharded form and both modes of B3 launch."""
    from slb2d_tpu_torch.dryrun import dryrun_multichip
    out = dryrun_multichip(4, device=card)
    assert out["mesh"] == (2, 2)
    assert out["launches"] == {"b2_sharded_tiles": 6,
                               "b2_sharded_replays": 3, "b3_shared": 2,
                               "b3_omega": 2}


@pytest.mark.cuda
def test_combined_sweep_on_slots_of_the_card(card):
    """The combined layout on a (2, 2) mesh of cuda:0 (a ragged grid with
    frames) against the batched engine on the card alone: the captured
    state bit for bit, the table at the sums' order."""
    import numpy as np
    import chip_smoke
    from slb2d_tpu_torch.config import SimConfig
    from slb2d_tpu_torch.parallel import ParameterSweep, make_mesh
    kw, params = chip_smoke.sweep_grid("ragged")
    cfg = SimConfig(display=4, dtype="f32", impl="torch", quiet=True, **kw)
    one = ParameterSweep(cfg, params, device=card, capture_state=True)
    ref = one.run()
    comb = ParameterSweep(cfg, params, capture_state=True,
                          mesh=make_mesh((2, 2), ("sweep", "space"),
                                         devices=[card] * 4),
                          space_axis="space")
    res = comb.run()
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=2e-6,
                                   err_msg=k)
    for got, want in zip(comb.final_ab, one.final_ab):
        np.testing.assert_array_equal(got, want)
