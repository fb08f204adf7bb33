"""The tests/perf probes P1-P3 (slb2d_tpu_torch/perf/) on the CPU: each
plain version against the JAX probe on the same numpy inputs (the Pallas
kernels in interpret mode, or the probe's chain restated where the kernel
is a closure without an interpret switch), the transposed step against
B1's plain version, the wrappers' routing on CPU tensors, the probes'
refusal of the CPU in main(), and the CLIs' profile-dir=.  The kernels
themselves run on a card (tests/test_torch_cuda.py)."""

import functools
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from slb2d_tpu_torch import cli as tcli
from slb2d_tpu_torch import perf
from slb2d_tpu_torch import sweep_cli as tsweep_cli
from slb2d_tpu_torch.ops import stencil, stepper_cuda
from slb2d_tpu_torch.perf import roll_cost_experiment as rce
from slb2d_tpu_torch.perf import transposed_experiment as te
from slb2d_tpu_torch.perf import vpu_roofline as vr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    """tests/perf/<name>.py as a module (tests/perf is not a package)."""
    path = os.path.join(ROOT, "tests", "perf", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perf_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- P1: the elementwise chain ------------------------------------------

def test_vpu_inputs_are_the_probes():
    probe = _probe("vpu_roofline")
    assert (vr.NHP, vr.MP, vr.K, vr.REPS) == (probe.NHP, probe.MP, probe.K,
                                             probe.REPS)
    for mine, theirs in zip(vr.make_coeffs(), probe.make_coeffs()):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)
    coef, bias, x = vr.make_coeffs((8, 128))
    np.testing.assert_array_equal(x, probe.make_coeffs()[2][:8, :128])


@pytest.mark.parametrize("reps", [1, 3])
def test_vpu_plain_is_the_numpy_float32_chain(reps):
    """mul+add bit for bit with numpy's float32 multiply and add."""
    coef, bias, x = vr.make_coeffs((8, 128))
    ref = x.copy()
    for _ in range(reps):
        for k in range(vr.K):
            ref = ref * coef[k] + bias[k]
    got = vr.chain(torch.from_numpy(x), coef, bias, reps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_vpu_plain_against_the_jnp_chain():
    """The probe's chain in jnp (XLA, jit, on the CPU).  XLA's CPU backend
    contracts y * coef + bias into an FMA, so its result is one of the two
    plain variants bit for bit (the FMA one, in the installed version);
    the mul+add variant is within rtol 1e-5 of it (64 steps moved it by
    1.7e-6 relative at most, measured)."""
    coef, bias, x = vr.make_coeffs((8, 128))

    @jax.jit
    def chain(y):
        for k in range(vr.K):
            y = y * coef[k] + bias[k]
        return y

    yj = np.asarray(chain(jnp.asarray(x)))
    mul_add = vr.chain_plain(torch.from_numpy(x), coef, bias, 1).numpy()
    fma = vr.chain_plain(torch.from_numpy(x), coef, bias, 1,
                         fma=True).numpy()
    assert np.array_equal(yj, fma) or np.array_equal(yj, mul_add)
    np.testing.assert_allclose(mul_add, yj, rtol=1e-5, atol=0)


def test_vpu_fma_plain_rounds_once():
    """The FMA variant's plain version rounds each chain step once: equal
    to float64 arithmetic rounded per step, and not the mul+add result."""
    coef, bias, x = vr.make_coeffs((4, 128))
    y = x.astype(np.float64)
    for k in range(vr.K):
        y = (y * np.float64(coef[k]) + np.float64(bias[k])).astype(
            np.float32).astype(np.float64)
    got = vr.chain(torch.from_numpy(x), coef, bias, 1, fma=True)
    np.testing.assert_array_equal(got.numpy(), y.astype(np.float32))
    assert not torch.equal(got, vr.chain(torch.from_numpy(x), coef, bias, 1))


@pytest.mark.parametrize("configs", [None, {"mul+add": [(2, 64)],
                                              "fma": [(4, 64), (2, 128)]}],
                         ids=["sweep", "chosen"])
def test_vpu_run_on_the_cpu(configs):
    res = vr.run("cpu", shape=(8, 128), reps=1, timed=1, configs=configs)
    pairs = len(vr.ILPS) * len(vr.BLOCKS)
    assert len(res["records"]) == (2 * pairs if configs is None else 3)
    assert res["rate"] == res["best"]["mul+add"]["rate"] > 0
    assert res["fma_rate"] == res["best"]["fma"]["rate"] > 0
    n = 8 * 128
    r = res["records"][0]
    assert r["rate"] == pytest.approx(2 * n * vr.K / (r["ms"] * 1e-3))
    json.dumps(res)


def test_vpu_chosen_pairs_are_built():
    for variant, (ilp, block) in vr.CHOSEN.items():
        assert variant in vr.VARIANTS and ilp in vr.ILPS and block % 32 == 0


def test_vpu_pipe_rate():
    assert vr.pipe_rate([]) is None
    assert vr.pipe_rate([(345.0, 1.0), (345.0, 1.0), (1980.0, 2.0)]) == (
        pytest.approx(132 * 128 * 1.98e9))
    assert "of the data sheet's" in vr.shares_line(3e13, [])
    assert "of the pipes'" in vr.shares_line(3e13, [(1980.0, 1.0)])


def _loop_counts(ilp, fma, control=vr.LOOP_CONTROL):
    ops = {"FMUL": 0 if fma else vr.K * ilp, "FADD": 0 if fma else vr.K * ilp,
           "FFMA": vr.K * ilp if fma else 0}
    loop = {**ops, "all": sum(ops.values()) + control}
    return {**ops, "all": loop["all"] + 40, "loop": loop}


def test_vpu_sass_check():
    good = {f"{v} ilp={i}": _loop_counts(i, v == "fma")
            for v in vr.VARIANTS for i in vr.ILPS}
    vr.check_sass(good)
    bad = {**good, "mul+add ilp=2": _loop_counts(2, True)}
    with pytest.raises(RuntimeError, match="mul.add ilp=2"):
        vr.check_sass(bad)
    # the constant-bank form: a uniform load per pair of values in the loop
    reloads = {**good, "fma ilp=4": _loop_counts(4, True, 3 + 64)}
    with pytest.raises(RuntimeError, match="fma ilp=4"):
        vr.check_sass(reloads)
    assert "mul+add ilp=2: loop FMUL 128 FADD 128 FFMA 0 of 259" in (
        vr.sass_line(good))


# cuobjdump -sass's form: a label line, then each instruction at its
# address; the turn loop closes with a predicated backward branch, and the
# function ends in a branch to itself
SASS = """
		Function : _ZN12_GLOBAL__N_19vpu_chainILi2ELb0EEEvPKfPfS2_S2_ii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   FMUL R2, R2, R3 ;        /* 0x0000000302027220 */
.L_x_0:
        /*0020*/                   FMUL R4, R4, R8 ;        /* 0x0000000804047220 */
        /*0030*/                   FADD R4, R4, R9 ;        /* 0x0000000904047221 */
        /*0040*/                   FFMA R5, R5, R8, R9 ;    /* 0x0000000805057223 */
        /*0050*/                   IADD3 R0, R0, 0x1, RZ ;  /* 0x0000000100007810 */
        /*0060*/              @!P0 BRA `(.L_x_0) ;          /* 0xfffffffc00008947 */
        /*0070*/                   EXIT ;                   /* 0x000000000000794d */
.L_x_1:
        /*0080*/                   BRA `(.L_x_1);           /* 0xfffffffc00fc7947 */
		Function : other
        /*0000*/                   FADD R1, R1, R2 ;        /* 0x0 */
        /*0010*/                   BRA 0x0 ;                /* 0x0 */
"""


def test_vpu_sass_functions():
    f = vr.sass_functions(SASS)
    chain = f["_ZN12_GLOBAL__N_19vpu_chainILi2ELb0EEEvPKfPfS2_S2_ii"]
    assert chain == {"FMUL": 2, "FADD": 1, "FFMA": 1, "all": 9,
                     "loop": {"FMUL": 1, "FADD": 1, "FFMA": 1, "all": 5}}
    assert f["other"]["loop"] == {"FMUL": 0, "FADD": 1, "FFMA": 0, "all": 2}


# ---- P2: roll + add passes ----------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(8, 128), (16, 128)])
def test_roll_plain_matches_the_pallas_probe(shape, axis):
    """Forms "two" and "one" bit for bit against _kernel_two and
    _kernel_one in interpret mode, K=3 passes; both kernels' wrappers
    take the plain version on CPU tensors."""
    probe = _probe("roll_cost_experiment")
    x, y = rce.make_inputs(shape)
    f32 = np.float32
    two = pl.pallas_call(
        functools.partial(probe._kernel_two, axis=axis, K=3),
        out_shape=[jax.ShapeDtypeStruct(shape, f32)] * 2,
        interpret=True)(x, y)
    one = pl.pallas_call(
        functools.partial(probe._kernel_one, axis=axis, K=3),
        out_shape=jax.ShapeDtypeStruct((2 * shape[0], shape[1]), f32),
        interpret=True)(np.concatenate([x, y]))
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    for fn in (rce.roll_plain, rce.roll_registers, rce.roll_passes):
        got_two = fn([X, Y], axis, 3)
        got_one = fn([torch.cat([X, Y])], axis, 3)
        for g, j in zip(got_two, two):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(got_one[0].numpy(), np.asarray(one))
    np.testing.assert_array_equal(X.numpy(), x)     # inputs unchanged


def test_roll_inputs_are_the_probes():
    probe = _probe("roll_cost_experiment")
    assert (rce.NH, rce.MP, rce.K) == (probe.NH, probe.MP, probe.K)
    x, y = rce.make_inputs()
    np.testing.assert_array_equal(
        x, np.random.RandomState(0).rand(probe.NH, probe.MP).astype(
            np.float32))
    np.testing.assert_array_equal(
        y, np.random.RandomState(1).rand(probe.NH, probe.MP).astype(
            np.float32))


def test_roll_wrappers_refuse_bad_input():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="axis"):
        rce.roll_registers([x], 2, 3)
    with pytest.raises(ValueError, match="float32"):
        rce.roll_passes([x, x.double()], 1, 3)
    with pytest.raises(ValueError, match="one or two"):
        rce.roll_registers([x, x, x], 1, 3)


def test_roll_run_on_the_cpu():
    res = rce.run("cpu", shape=(8, 128), K=3, timed=1)
    assert len(res["records"]) == 2 * 2 * 2
    assert set(res["one_over_two"]) == {
        f"{k} axis {a}" for k in rce.KERNELS for a in rce.AXES}
    assert all(r["us_per_pass"] > 0 for r in res["records"])


# ---- P3: the transposed step --------------------------------------------

def _chunks(xs, split):
    return ((xs[:split], 0), (xs[split:], split % 2))


@pytest.mark.parametrize("nhl", [16, 32])
@pytest.mark.parametrize("split", [21, 30])
def test_transposed_plain_is_b1_plain_bit_for_bit(nhl, split):
    """The transposed step, transposed back, equals B1's plain version
    (av off) bit for bit over 41 steps in two chunks that split the
    parity (and at NHL=32 with 16 padding columns, which stay zero)."""
    model, c, tc, state0, xs = te.setup("cpu", 8, 64, nhl, 41)
    st, ref = te.transpose_state(state0, nhl), state0.clone()
    for part, parity in _chunks(xs, split):
        st = te.run_chunk(tc, st, part, parity)
        ref, _ = stepper_cuda.run_chunk_plain(c, ref, part, parity)
    for f, v in te.untranspose(st, model.NHP).items():
        assert torch.equal(v, getattr(ref, f)), f
    for f in ("a", "b", "a_hs", "b_hs"):
        assert bool((getattr(st, f)[:, model.NHP:] == 0).all())
    assert float(ref.a.abs().max()) > 0


def test_transposed_xs_table_is_the_probes():
    """setup's table is build_xs_table's fast-mode table without av, as the
    JAX probe builds it (slb2d_tpu/ops/stepper_pallas.py:build_xs_table)."""
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.models.superlattice import SuperlatticeModel
    from slb2d_tpu.ops import stencil as jstencil
    from slb2d_tpu.ops.stepper_pallas import build_xs_table
    model, c, tc, state0, xs = te.setup("cpu", 8, 64, 16, 40)
    jcfg = SimConfig(display=4, t_start=10.0, n_harmonics=8, g_grid=64,
                     dtype="f32", **te.PHYS)
    jm = SuperlatticeModel(jcfg)
    jxs = build_xs_table(jm, jstencil.consts_from_model(jm), 0.0, 0, 40,
                         av_enabled=False, exact=False)
    np.testing.assert_array_equal(xs, np.asarray(jxs))


# the JAX probe's faithful grid at N=8 M=64: PhiY ±0.16 gives dPhi=0.005,
# so bdt is the 0.005 that _kernel_T hard-codes, with BASELINE #4's other
# physics
P3_GRID = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
               n_harmonics=8, phi_y_min=-0.16, phi_y_max=0.16, B=0.1,
               t_start=10.0, g_grid=64, dt=1e-3, dtype="f32")


def test_transposed_plain_matches_the_pallas_probe():
    """The plain transposed step against _kernel_T in interpret mode, 16
    steps (two of its 8-step unrolls) from the JAX bootstrap state, NHL=16.
    The probe restores a one-step-old edge at column M+1, and a step reads
    m±1 twice, so its error reaches columns m >= M + 1 - 2·16 (measured:
    2.3e-3 at m=M after 8 steps); the columns below are compared.  There
    the probe's hard-coded float32 bdt (0.005) and nu2 lie an ulp from the
    model's, and XLA contracts multiply-adds: measured up to 5.5e-6
    relative, so rtol 3e-5, atol 1e-8."""
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.models.superlattice import SuperlatticeModel
    from slb2d_tpu.ops import stencil as jstencil
    from slb2d_tpu.ops.stepper_pallas import build_xs_table
    from slb2d_tpu_torch.config import SimConfig as TSimConfig
    from slb2d_tpu_torch.models.superlattice import (
        SuperlatticeModel as TModel)
    probe = _probe("transposed_experiment")
    K, NHL = 16, 16
    jm = SuperlatticeModel(SimConfig(display=4, **P3_GRID))
    jc = jstencil.consts_from_model(jm)
    cT = probe.transposed_consts(jc, jm, NHL)
    jstate = jstencil.bootstrap_state(jc, jm)
    xs = np.asarray(build_xs_table(jm, jc, 0.0, 0, K, av_enabled=False,
                                   exact=False))
    D, NHP, MP = np.float32, jm.NHP, jm.MP

    def pad(a):
        out = np.zeros((MP, NHL), D)
        out[:, :NHP] = np.asarray(a).T
        return out

    outs = pl.pallas_call(
        functools.partial(probe._kernel_T, n_steps=K, unroll=8, parity0=0,
                          edge_row=jm.M + 1),
        out_shape=[jax.ShapeDtypeStruct((MP, NHL), D)] * 4,
        input_output_aliases={1: 0, 2: 1, 3: 2, 4: 3}, interpret=True)(
        xs, *(pad(getattr(jstate, f)) for f in ("a", "b", "a_hs", "b_hs")),
        cT.a0, cT.a0_ghost, cT.phi, cT.n_float, cT.n_ge2, cT.w_n,
        np.asarray(cT.row_update, D), np.asarray(cT.col_main, D),
        np.asarray(cT.col_half, D))
    tm = TModel(TSimConfig(display=4, **P3_GRID))
    tc = te.transposed_consts(stencil.consts_from_model(tm, "cpu"), tm, NHL)
    s0 = stencil.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in stencil.FIELDS}, "cpu")
    st = te.run_chunk(tc, te.transpose_state(s0, NHL), xs, 0)
    reach = jm.M + 1 - 2 * K
    for f, out in zip(("a", "b", "a_hs", "b_hs"), outs):
        np.testing.assert_allclose(getattr(st, f).numpy()[:reach],
                                   np.asarray(out)[:reach], rtol=3e-5,
                                   atol=1e-8, err_msg=f)
    # the probe's edge shortcut does move the columns it reaches
    assert not np.allclose(st.b.numpy()[reach:], np.asarray(outs[1])[reach:],
                           rtol=3e-5, atol=1e-8)


def test_transposed_run_on_the_cpu():
    res = te.run("cpu", n_harmonics=8, g_grid=64, NHL=16, K=5, timed=1)
    assert res["NHP"] == 16 and res["MP"] == 128 and res["K"] == 5
    assert res["us_per_step"] > 0 and res["b1_us_per_step"] > 0


def test_transposed_consts_refuse_a_narrow_layout():
    model, c, tc, state0, xs = te.setup("cpu", 8, 64, 16, 2)
    with pytest.raises(ValueError, match="NHL=8"):
        te.transposed_consts(c, model, 8)


def test_clock_line():
    assert perf.clock_line([]) == "SM clock not sampled"
    line = perf.clock_line([(1980.0, 120.5), (1755.0, 184.0),
                            (1980.0, 90.0)])
    assert line == ("SM clock 1755-1980 MHz (median 1980), power draw up "
                    "to 184.0 W over 3 samples")


# ---- entry points -------------------------------------------------------

@pytest.mark.parametrize("mod", [vr, rce, te],
                         ids=["vpu_roofline", "roll_cost_experiment",
                              "transposed_experiment"])
def test_probe_main_refuses_the_cpu(mod, monkeypatch, capsys):
    """main() exits 1 with an error without a card, and runs nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "run", lambda *a, **k: pytest.fail("ran"))
    assert mod.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and perf.NO_CARD in out.err


# ---- profile-dir= (the CLIs under torch.profiler) -----------------------

# a display-4 run of 8 steps (omega=1000: T=6.3 ms) on the CPU
PROFILE_ARGV = ["E_dc=1.0", "E_omega=2.0", "omega=1000.0", "mu=1.0",
                "alpha=0.9495", "n-harmonics=4", "PhiYmin=-10",
                "PhiYmax=10", "B=0.1", "t-max=0.002", "dt=1e-3",
                "g-grid=24", "impl=torch", "device=cpu", "quiet=1"]


def _traces(d):
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    for f in files:
        with open(f) as fh:
            assert json.load(fh)["traceEvents"]
    return files


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    d = str(tmp_path / "prof")
    assert tcli.main(["display=4"] + PROFILE_ARGV
                     + [f"profile-dir={d}"]) == 0
    assert len(_traces(d)) == 1
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l and not l.startswith("#")]
    assert len(lines) == 1 and len(lines[0].split()) == 13
    assert tcli.main(["display=4"] + PROFILE_ARGV) == 0    # no key: none
    assert len(_traces(d)) == 1


def test_sweep_cli_profile_dir_writes_a_trace(tmp_path):
    d = str(tmp_path / "prof")
    out = str(tmp_path / "sweep.txt")
    assert tsweep_cli.main(PROFILE_ARGV + [f"profile-dir={d}", f"o={out}",
                                           "sweep:E_dc=0.5,1.5,2"]) == 0
    assert len(_traces(d)) == 1
    with open(out) as fh:
        assert len(fh.read().splitlines()) == 3


def test_profile_dir_is_parsed():
    from slb2d_tpu_torch import config
    cfg = config.parse_cmd(["display=4"] + PROFILE_ARGV
                           + ["profile-dir=/x/y"])
    assert cfg.profile_dir == "/x/y"
    assert config.parse_cmd(["display=4"] + PROFILE_ARGV).profile_dir is None


def test_profiled_without_a_dir_is_a_no_op(tmp_path):
    with tcli.profiled(None, torch.device("cpu")):
        pass
    with tcli.profiled("", torch.device("cpu")):
        pass
    assert not os.listdir(tmp_path)
