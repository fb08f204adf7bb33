"""The port's copies of the numpy-only host modules against their JAX-package
originals, bit for bit: model, schedule, CLI parsing, writers, xs tables,
frame reconstruction.

The port copies these modules instead of importing them (any import of
slb2d_tpu loads jax); these tests are what keeps the copies from drifting.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from slb2d_tpu import config as jcfg
from slb2d_tpu.io import writers as jwriters
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import frames as jframes
from slb2d_tpu.ops import observables as jobs
from slb2d_tpu.ops import stepper_pallas as jstep
from slb2d_tpu.runtime import schedule as jsched

from slb2d_tpu_torch import config as tcfg
from slb2d_tpu_torch.io import writers as twriters
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel as TModel
from slb2d_tpu_torch.ops import frames as tframes
from slb2d_tpu_torch.ops import observables as tobs
from slb2d_tpu_torch.ops import stepper_cuda as tstep
from slb2d_tpu_torch.runtime import schedule as tsched

BASE = dict(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
            alpha=0.9495, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
            t_start=1.0, dt=1e-3)

MODEL_CASES = [
    ("f32", 1, 3), ("f64", 8, 64), ("f32", 20, 200), ("f64", 20, 3),
]


def _models(dtype, N, M, **kw):
    args = {**BASE, **kw, "n_harmonics": N, "g_grid": M, "dtype": dtype}
    return JModel(jcfg.SimConfig(**args)), TModel(tcfg.SimConfig(**args))


def _assert_same(x, y, name):
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray), name
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
        # bit for bit, including the sign of zero
        assert x.tobytes() == y.tobytes(), name
    else:
        assert type(x) is type(y), name
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), name


@pytest.mark.parametrize("dtype,N,M", MODEL_CASES)
def test_superlattice_model_bit_for_bit(dtype, N, M):
    jm, tm = _models(dtype, N, M)
    keys = set(vars(jm)) - {"cfg"}
    assert keys == set(vars(tm)) - {"cfg"}
    for k in sorted(keys):
        _assert_same(getattr(jm, k), getattr(tm, k), k)
    assert jm.initial_a().tobytes() == tm.initial_a().tobytes()
    jp, tp = jm.scalar_params(), tm.scalar_params()
    assert jp.keys() == tp.keys()
    for k in jp:
        _assert_same(jp[k], tp[k], k)


def _schedule(mod, model, display, fn="iter_chunks", **kw):
    carry = {}
    chunks = list(getattr(mod, fn)(
        omega=model.omega, dt=model.dt, t0=0.0,
        t_max=float(model.np_dtype(model.np_dtype(model.cfg.t_start)
                                   + model.T)),
        t_start=model.cfg.t_start, E_omega=model.E_omega, display=display,
        frame_start=0.0, T=model.T, dtype=model.np_dtype, carry_out=carry,
        **kw))
    return chunks, carry


@pytest.mark.parametrize("display,dtype,kw", [
    (4, "f32", dict(chunk_max=200)),
    (4, "f64", dict(chunk_max=333)),
    (77, "f32", dict(chunk_max=512, break_on_e77=False)),
    (77, "f64", dict(chunk_max=512, break_on_e77=True)),
])
def test_iter_chunks_bit_for_bit(display, dtype, kw):
    jm, tm = _models(dtype, 8, 24, omega=10.0, t_start=0.2, display=display)
    jc, jcarry = _schedule(jsched, jm, display, **kw)
    tc, tcarry = _schedule(tsched, tm, display, **kw)
    assert len(jc) == len(tc) > 1
    assert jcarry == tcarry
    for a, b in zip(jc, tc):
        assert (a.n_steps, a.event, a.t_first, a.t_last, a.emit_idx) == \
               (b.n_steps, b.event, b.t_first, b.t_last, b.emit_idx)
        assert a.xs.keys() == b.xs.keys()
        for k in a.xs:
            _assert_same(a.xs[k], b.xs[k], k)
    if display == 77 and not kw.get("break_on_e77", True):
        assert sum(len(ch.emit_idx) for ch in tc) > 10


def test_iter_chunks_sequential_matches_vectorized():
    _, tm = _models("f32", 8, 24, omega=10.0, t_start=0.2, display=77)
    a, ca = _schedule(tsched, tm, 77, chunk_max=300, break_on_e77=False)
    b, cb = _schedule(tsched, tm, 77, fn="iter_chunks_sequential",
                      chunk_max=300, break_on_e77=False)
    assert ca == cb and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.emit_idx == y.emit_idx and x.n_steps == y.n_steps
        for k in x.xs:
            np.testing.assert_array_equal(x.xs[k], y.xs[k])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("exact", [True, False])
def test_xs_tables_bit_for_bit(dtype, exact):
    jm, tm = _models(dtype, 8, 64, omega=10.0, t_start=0.1)
    from slb2d_tpu.ops.stencil import consts_from_model
    # numpy scalars; a finite t_end exercises the averaging window's end
    c = consts_from_model(jm)._replace(t_end=jm.np_dtype(0.3))
    jx = jstep.build_xs_table(jm, c, 0.25, 3, 97, av_enabled=True,
                              exact=exact)
    tx = tstep.build_xs_table(tm, c, 0.25, 3, 97, av_enabled=True,
                              exact=exact)
    assert 0 < jx[:, 6].sum() < 97
    _assert_same(jx, tx, "build_xs_table")
    chunks, _ = _schedule(jsched, jm, 4, chunk_max=200)
    _assert_same(jstep.pack_xs_dict(chunks[1].xs, jm.np_dtype),
                 tstep.pack_xs_dict(chunks[1].xs, tm.np_dtype),
                 "pack_xs_dict")
    assert (jstep.XS_LANES, jstep.OBS_LANES, jstep.SCALAR_FIELDS) == \
           (tstep.XS_LANES, tstep.OBS_LANES, tstep.SCALAR_FIELDS)


def _parse(mod, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            return mod.parse_cmd(argv), None
        except mod.ConfigError as e:
            return None, (e.code, err.getvalue())


REQ = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1",
       "alpha=0.9495", "n-harmonics=20", "PhiYmin=-10", "PhiYmax=10",
       "B=0.1", "t-max=10"]


@pytest.mark.parametrize("argv", [
    REQ,
    REQ + ["dt=1e-3", "g-grid=4000", "dtype=f64", "o=out.txt", "quiet=1"],
    REQ + ["n-harmonics=7.9", "steps-per-chunk=100", "exact-time=0",
           "checkpoint=c.npz", "frame-start=0.5", "device=1"],
    REQ + ["stop", "g-grid=17"],           # parsing stops at a bare token
    REQ + ["bogus=1", "display=77"],       # unknown keys ignored
    REQ[:-1],                              # missing t-max
    REQ + ["dt=abc"],                      # invalid value
    REQ + ["display=5"],
    REQ + ["t-max=0"],
    REQ + ["dtype=f16"],
    REQ + ["g-grid=2"],
    REQ + ["read-from=file"],
    REQ + ["shards=0"],
])
def test_parse_cmd_parity(argv):
    jc, jerr = _parse(jcfg, argv)
    tc, terr = _parse(tcfg, argv)
    assert jerr == terr
    if jc is None:
        assert tc is None
        return
    shared = {f.name for f in dataclasses.fields(tc)}
    jd = {k: v for k, v in dataclasses.asdict(jc).items() if k in shared}
    assert jd == dataclasses.asdict(tc)


@pytest.mark.parametrize("jax_impl,port_impl", [
    ("xla", "torch"), ("pallas", "cuda"), ("stream", "stream")])
def test_parse_cmd_names_counterpart_engine(jax_impl, port_impl):
    tc, terr = _parse(tcfg, REQ + [f"impl={jax_impl}"])
    if jax_impl == port_impl:        # the temporal-tiling engine: both
        assert terr is None and tc.impl == jax_impl
        assert _parse(jcfg, REQ + [f"impl={jax_impl}"])[1] is None
    else:
        assert tc is None and terr[0] == 1
        assert f"impl={port_impl}" in terr[1]
    tc, terr = _parse(tcfg, REQ + [f"impl={port_impl}"])
    assert terr is None and tc.impl == port_impl
    assert _parse(tcfg, REQ + ["impl=auto"])[0].impl == "auto"


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_write_display4_byte_identical(dtype, capsys):
    jm, tm = _models(dtype, 20, 200, t_start=10.0)
    rng = np.random.default_rng(7)
    D = jm.np_dtype
    a = (rng.standard_normal((2, jm.MP)) * 0.1).astype(D)
    b = (rng.standard_normal((2, jm.MP)) * 0.01).astype(D)
    av = rng.standard_normal(8).astype(D)
    outs = []
    for mod, model in ((jwriters, jm), (twriters, tm)):
        buf = io.StringIO()
        norm = mod.write_display4(buf, model, model.cfg, a, b, av,
                                  quiet=False, t_start=10.5)
        outs.append((buf.getvalue(), np.asarray(norm).tobytes(),
                     capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0].count("\n") == 3


def test_observables_and_native_bridge_agree():
    jm, tm = _models("f32", 20, 200)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((jm.NHP, jm.MP)).astype(np.float32)
    b = rng.standard_normal((jm.NHP, jm.MP)).astype(np.float32)
    for bounds in ("d4", "av"):
        _assert_same(np.asarray(jobs.instantaneous(jm, a, b, bounds=bounds)),
                     np.asarray(tobs.instantaneous(tm, a, b, bounds=bounds)),
                     bounds)
    _assert_same(jobs.eval_norm(jm, a), tobs.eval_norm(tm, a), "norm")
    from slb2d_tpu.io import native as jn
    from slb2d_tpu_torch.io import native as tn
    # the same library path (or the same absence of it) in both packages
    assert (jn._load() is None) == (tn._load() is None)
    assert jsched.count_steps(0.0, 7.2831855, 1e-3) == \
           tsched.count_steps(0.0, 7.2831855, 1e-3)


def test_repl_scanner_parity():
    session = ("E_dc 1.5x 0.40\nbogus 7 0.30\nB .25e0 0.35\n"
               "exit 0.9 0.30\nmu abc 1.1 0.25\nomega 12 0.3 exit\n")
    results = []
    for mod in (jcfg, tcfg):
        stream = io.StringIO(session)
        seq = []
        while True:
            mut = mod.scan_for_new_parameters(stream)
            seq.append(mut)
            if mut is None:
                break
        results.append(seq)
    assert results[0] == results[1]
    assert len(results[1]) == 6 and results[1][-2] == ("omega", 12.0, 0.3)


@pytest.mark.parametrize("dtype,N,M", [("f32", 8, 24), ("f64", 20, 200)])
def test_frame_reconstruction_bit_for_bit(dtype, N, M):
    """ops/frames.py's host part: the phi_x grid, the cos/sin tables, the
    reconstruction (clamped or not) and the equilibrium frame."""
    jm, tm = _models(dtype, N, M)
    D = jm.np_dtype
    _assert_same(jframes.phi_x_grid(D), tframes.phi_x_grid(D), "phi_x_grid")
    jr, tr = jframes.FrameReconstructor(jm), tframes.FrameReconstructor(tm)
    for k in ("phi_x", "cos_t", "sin_t"):
        _assert_same(getattr(jr, k), getattr(tr, k), k)
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((jm.NHP, jm.MP)) * 0.1).astype(D)
    b = (rng.standard_normal((jm.NHP, jm.MP)) * 0.1).astype(D)
    for lo, hi, clamp in ((1, M + 2, True), (1, M, False)):
        _assert_same(jr.reconstruct(a, b, lo, hi, clamp=clamp),
                     tr.reconstruct(a, b, lo, hi, clamp=clamp),
                     f"reconstruct {lo}:{hi} clamp={clamp}")
    _assert_same(jr.reconstruct_equilibrium(1, M),
                 tr.reconstruct_equilibrium(1, M), "equilibrium")


def test_device_key_takes_cpu_or_an_ordinal():
    """The port's device= also takes cpu; an ordinal parses as before."""
    tc, terr = _parse(tcfg, REQ + ["device=cpu"])
    assert terr is None and tc.device == "cpu"
    assert _parse(tcfg, REQ + ["device=2"])[0].device == 2
    assert _parse(tcfg, REQ + ["device=gpu"])[1] == _parse(
        jcfg, REQ + ["device=gpu"])[1]
