"""The stacked sweep kernel's two forms (ops/sweep_stack_cuda.py,
csrc/sweep_stack.cu): which form and cluster size a sweep gets, and the
runner on the CPU whatever size is asked for.

cluster_plan is pure arithmetic on a point's shape and dtype, held here to
the kernel source's budget and to the shapes the sweeps run.  On the CPU
the runner runs the kernel's plain version in either form, so its result
is held bit for bit to run_chunk_plain / run_chunk_plain_omega, and, at
every cluster size, to the JAX stacked runner (impl=pallas in interpret
mode) at tests/test_torch_sweep.py's f32 envelope (rtol 1e-4, atol 1e-7:
XLA contracts multiply-adds on the CPU and the port does not).  The CUDA
forms themselves are held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.ops.sweep_stack import SweepStackRunner as JRunner
from slb2d_tpu.parallel.sweep import ParameterSweep as JSweep

from slb2d_tpu_torch.config import SimConfig as TConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import _build
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.ops import sweep_stack_cuda as ssc
from slb2d_tpu_torch.ops.stencil import CAP_KEYS
from slb2d_tpu_torch.parallel.sweep import ParameterSweep as TSweep

CPU = torch.device("cpu")

# tests/test_torch_sweep.py's ragged grid (N=8 M=24: NHP=16, MP=128);
# point 2 is dc-only, mu swept
CFG = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
           alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
           B=0.1, t_start=0.2, g_grid=24, dt=1e-3, quiet=True)
PARAMS = {"E_dc": np.linspace(0.3, 2.0, 6),
          "E_omega": np.array([2.0, 2.0, 0.0, 1.5, 2.0, 2.0]),
          "mu": np.array([1.0, 1.2, 1.0, 0.8, 1.0, 1.1])}
OMEGA_PARAMS = {"omega": np.array([8.0, 10.0, 12.0, 14.0, 10.0]),
                "E_dc": np.linspace(0.4, 1.8, 5),
                "E_omega": np.array([2.0, 2.0, 0.0, 1.5, 2.0])}
F32_STATE = dict(rtol=1e-4, atol=1e-7)

DTYPES = {"f32": np.float32, "f64": np.float64}


def shape_of(**kw):
    """(NHP, MP) of a model with these SimConfig keywords."""
    m = SuperlatticeModel(TConfig(**{**CFG, **kw}))
    return m.NHP, m.MP


def port_sweep(dtype, params=PARAMS, **kw):
    sw = TSweep(TConfig(**{**CFG, **kw}, impl="torch", dtype=dtype), params,
                device=CPU)
    sw.engine = "cuda"
    return sw


# ---- 1. the plan ------------------------------------------------------

def test_cluster_plan_at_the_sweep_and_paper_shape():
    """N=40 M=500 (the 64-point sweep and the paper map): 2 blocks a point
    in float, 4 in double, each rank's 4 slab arrays of R x 512 plus its
    rows' two edges."""
    NHP, MP = shape_of(n_harmonics=40, g_grid=500)
    assert (NHP, MP) == (48, 512)
    assert ssc.cluster_plan(NHP, MP, np.float32) == (2, 196_800)
    assert ssc.cluster_plan(NHP, MP, np.float64) == (4, 196_800)
    assert 4 * 24 * 512 * 4 + 2 * 24 * 4 == 196_800
    for D, too_small in ((np.float32, 1), (np.float64, 2)):
        assert ssc.cluster_smem_bytes(NHP, MP, D, too_small) is None


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("grid", [(8, 24), (6, 29), (8, 64)])
def test_ragged_grids_take_one_block(dtype, grid):
    """The test grids (tests/test_sweep_stack.py's, tests/
    test_sweep_pallas.py's N=6 M=29, the step kernel's N=8 M=64) fit one
    block: the cluster form with a single rank."""
    NHP, MP = shape_of(n_harmonics=grid[0], g_grid=grid[1])
    cs, smem = ssc.cluster_plan(NHP, MP, DTYPES[dtype])
    assert cs == 1
    assert smem == (4 * NHP * MP + 2 * NHP) * np.dtype(DTYPES[dtype]).itemsize


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("grid", [(100, 4000), (100, 12000), (400, 4000)])
def test_points_past_any_cluster_take_the_streaming_form(dtype, grid):
    """BASELINE #4's N=100 M=4000 (6.8 MB a point in float) and the wider
    and taller grids: no portable cluster holds a point."""
    NHP, MP = shape_of(n_harmonics=grid[0], g_grid=grid[1])
    assert ssc.cluster_plan(NHP, MP, DTYPES[dtype]) is None
    assert all(ssc.cluster_smem_bytes(NHP, MP, DTYPES[dtype], cs) is None
               for cs in ssc.CLUSTER_SIZES)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_every_plan_is_a_valid_split(dtype):
    """Over NHP = 8..512 (multiples of 8) and MP = 128..16384 (multiples of
    128): a plan is the smallest portable size that divides NHP into
    slabs of at least 2 rows whose bytes and the sums' scratch fit
    SMEM_LIMIT."""
    D = DTYPES[dtype]
    item = np.dtype(D).itemsize
    planned = 0
    for NHP in range(8, 513, 8):
        for MP in range(128, 16385, 128):
            plan = ssc.cluster_plan(NHP, MP, D)
            fits = [cs for cs in ssc.CLUSTER_SIZES if NHP % cs == 0
                    and NHP // cs >= 2
                    and ((4 * NHP // cs * MP + 2 * NHP // cs) + 224) * item
                    <= 232_448]
            if plan is None:
                assert not fits, (NHP, MP)
                continue
            planned += 1
            cs, smem = plan
            R = NHP // cs
            assert cs == min(fits), (NHP, MP)
            assert NHP % cs == 0 and R >= 2
            assert smem == (4 * R * MP + 2 * R) * item
            assert smem + ssc.SUM_SCRATCH * item <= ssc.SMEM_LIMIT
    assert planned > 100


def test_cluster_budget_matches_the_kernel_source():
    """The budget cluster_plan computes with is the one the kernel checks
    and allocates (csrc/sweep_stack.cu), as test_pp_lanes_match_the_kernel
    _source holds the per-point lanes."""
    src = open(os.path.join(os.path.dirname(ssc.__file__), "..", "csrc",
                            "sweep_stack.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (-?\d+);",
                             src).group(1))

    assert const("SMEM_LIMIT") == ssc.SMEM_LIMIT == 232_448
    assert const("SLAB_ARRAYS") == ssc.SLAB_ARRAYS == 4
    assert const("EDGE_ARRAYS") == ssc.EDGE_ARRAYS == 2
    assert const("NO_ACTIVE_CLUSTER") == ssc.NO_ACTIVE_CLUSTER
    # the kernel takes the powers of two up to CLUSTER_MAX
    cmax = const("CLUSTER_MAX")
    assert ssc.CLUSTER_SIZES == tuple(2 ** k for k in range(
        cmax.bit_length()))
    assert "(cs & (cs - 1)) != 0" in src and "NHP / cs < 2" in src
    # block_sums<T, 3> and block_sums<T, CAP_COLS> keep 32 warps' values
    assert const("SWEEP_BLOCK") == 1024
    assert const("SUM_SCRATCH") == ssc.SUM_SCRATCH == (3 + len(CAP_KEYS)) * 32
    assert ("((size_t)SLAB_ARRAYS * R * MP + (size_t)EDGE_ARRAYS * R) * "
            "sizeof(T)") in src


# ---- 2. the runner on the CPU -----------------------------------------

@functools.lru_cache(maxsize=None)
def jax_after(n1, n2):
    """The JAX stacked runner's state after n1 then n2 steps from its
    initial state, and that initial state (numpy)."""
    jsw = JSweep(JConfig(**CFG, impl="pallas", dtype="f32"), PARAMS)
    jstate = jsw._initial_states()
    start = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    jr = JRunner(jsw, g_points=4)
    for n in (n1, n2):
        jstate = jr.advance(jstate, n)
    return start, {k: np.asarray(v) for k, v in jstate._asdict().items()}


@pytest.mark.parametrize("cluster_size", [None, 0, 1, 2, 4, 8])
def test_runner_on_cpu_runs_the_plain_version_at_any_size(cluster_size):
    """The shared-omega runner forced to each form and size records it,
    launches and builds nothing, and gives the plain version's bits; the
    same state as the JAX stacked runner within the f32 envelope."""
    sw = port_sweep("f32")
    runner = ssc.SweepStackRunner(sw, cluster_size=cluster_size)
    want_cs = 1 if cluster_size is None else cluster_size
    assert runner.cluster_size == want_cs
    assert runner.form == ("streaming" if want_cs == 0 else "cluster")
    assert runner.smem_bytes == (0 if want_cs == 0 else ssc.cluster_smem_bytes(
        runner.NHP, runner.MP, np.float32, want_cs))
    start, ref = jax_after(25, 35)
    state = ts.state_from_numpy(start, CPU)
    plain = state.clone()
    for n in (25, 35):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        state = runner.advance(state, n)
        plain = ssc.run_chunk_plain(sw.consts, plain, xs, parity0,
                                    runner.egate)
    got = ts.state_to_numpy(state)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(plain, f)), f
        np.testing.assert_allclose(got[f], ref[f], err_msg=f, **F32_STATE)
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_array_equal(got["av"][2], 0)       # dc-only point
    assert runner.launches == 0 and _build._LOADED is None


@pytest.mark.parametrize("cluster_size", [None, 0, 8])
def test_omega_runner_on_cpu_runs_the_plain_version_at_any_size(
        cluster_size):
    """The per-omega runner forced to a form and size gives the plain
    version's state and capture bit for bit over 61 steps in two chunks."""
    sw = port_sweep("f32", params=OMEGA_PARAMS, t_start=0.01)
    runner = ssc.SweepStackRunner(sw, cluster_size=cluster_size)
    assert runner.per_omega
    assert runner.form == ("streaming" if cluster_size == 0 else "cluster")
    state = sw._initial_states()
    plain = state.clone()
    cap = {k: torch.zeros(sw.B, dtype=torch.float32) for k in CAP_KEYS}
    pcap = dict(cap)
    for n in (31, 30):
        xs = runner.chunk_table(n)
        parity0 = runner.step0 % 2
        state, cap = runner.advance(state, n, cap=cap)
        plain, pcap = ssc.run_chunk_plain_omega(
            sw.consts, plain, pcap, xs, parity0, runner.egate, runner.pp,
            runner.w_d4, runner.w_d4_phi)
    for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b", "av"):
        assert torch.equal(getattr(state, f), getattr(plain, f)), f
    for k in CAP_KEYS:
        assert torch.equal(cap[k], pcap[k]), k
    assert runner.launches == 0 and _build._LOADED is None


@pytest.mark.parametrize("cluster_size", [3, 16, -1])
def test_runner_refuses_sizes_that_are_not_portable(cluster_size):
    with pytest.raises(ValueError, match="cannot hold"):
        ssc.SweepStackRunner(port_sweep("f32"), cluster_size=cluster_size)


@pytest.mark.parametrize("dtype,cluster_size", [("f32", 1), ("f64", 1),
                                                ("f64", 2)])
def test_runner_refuses_clusters_too_small_for_the_point(dtype,
                                                         cluster_size):
    """At N=40 M=500 one block cannot hold a point (393,600 bytes in
    float), nor two in double; nothing falls back to another size."""
    sw = port_sweep(dtype, params={"E_dc": np.array([0.5, 1.0])},
                    n_harmonics=40, g_grid=500)
    with pytest.raises(ValueError, match="cannot hold"):
        ssc.SweepStackRunner(sw, cluster_size=cluster_size)
    runner = ssc.SweepStackRunner(sw)
    assert runner.form == "cluster"
    assert runner.cluster_size == (2 if dtype == "f32" else 4)
