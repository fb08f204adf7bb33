"""The port's driver (runtime/loop.Simulation, cli, checkpoint) against the
JAX driver and the reference C solver's recorded output.

impl=torch runs on the CPU here.  f64 against the JAX Simulation at
rtol=1e-12 on all 13 display-4 columns (atol=1e-15 for columns that
cancel to ~0), headers byte for byte; the golden fixtures at
tests/test_golden.py's tolerances (f64 1e-8; f32 2e-5 with atol 8e-6, the
reference's own FMA-rebuild envelope, docs/DEVIATIONS.md D7).
"""

import numpy as np
import pytest
import torch

from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.runtime import checkpoint as jckpt
from slb2d_tpu.runtime.loop import Simulation as JSimulation

from slb2d_tpu_torch import cli
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel
from slb2d_tpu_torch.ops import stencil as ts
from slb2d_tpu_torch.runtime import checkpoint as tckpt
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import COMMON, d4_values, read_gold

TINY = dict(display=4, n_harmonics=8, g_grid=24, t_start=0.5, omega=10.0)
CPU = torch.device("cpu")


def run_port(tmp_path, monkeypatch, **kw):
    monkeypatch.chdir(tmp_path)
    cfg = SimConfig(out_file="port.txt", impl="torch",
                    **{**COMMON, **kw})
    Simulation(cfg, device=CPU).run()
    return (tmp_path / "port.txt").read_text()


def headers(text):
    return [l for l in text.splitlines() if l.startswith("#")]


def test_display4_matches_jax_simulation_f64(tmp_path, monkeypatch):
    port = run_port(tmp_path, monkeypatch, dtype="f64", **TINY)
    cfg = JConfig(out_file="jax.txt", **{**COMMON, **TINY}, dtype="f64")
    JSimulation(cfg).run()
    ref = (tmp_path / "jax.txt").read_text()
    pl, rl = d4_values(port), d4_values(ref)
    assert len(pl) == len(rl) == 1 and pl[0].shape == (13,)
    np.testing.assert_allclose(pl[0], rl[0], rtol=1e-12, atol=1e-15)
    assert headers(port) == headers(ref)


@pytest.mark.parametrize("gold,dtype,tol", [
    ("d4_small_f64.txt", "f64", 1e-8),
    ("d4_small_f32.txt", "f32", 2e-5),
])
def test_display4_vs_reference(tmp_path, monkeypatch, gold, dtype, tol):
    gold_text = read_gold(gold)
    mine = run_port(tmp_path, monkeypatch, display=4, dtype=dtype,
                    n_harmonics=20, g_grid=200, t_start=1.0)
    gl, ml = d4_values(gold_text), d4_values(mine)
    assert len(gl) == len(ml) == 1
    np.testing.assert_allclose(ml[0], gl[0], rtol=tol,
                               atol=8e-6 if dtype == "f32" else tol * 0.1)
    assert headers(gold_text) == headers(mine)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_port_checkpoint_loads_in_jax(tmp_path, monkeypatch, dtype):
    run_port(tmp_path, monkeypatch, dtype=dtype, checkpoint="ck.npz",
             **TINY)
    jm = JModel(JConfig(**{**COMMON, **TINY}, dtype=dtype))
    st, extra = jckpt.load_state(str(tmp_path / "ck.npz"), jm)
    tm = SuperlatticeModel(SimConfig(**{**COMMON, **TINY}, dtype=dtype))
    mine, mine_extra = tckpt.load_state(str(tmp_path / "ck.npz"), tm)
    got = ts.state_to_numpy(mine)
    for f in js.State._fields:
        ref = np.asarray(getattr(st, f))
        assert got[f].dtype == ref.dtype and got[f].shape == ref.shape, f
        np.testing.assert_array_equal(got[f], ref, err_msg=f)
    assert int(st.step) > 1000
    assert set(extra) == set(mine_extra) >= {"t0", "frame_time"}


def test_jax_checkpoint_loads_in_port(tmp_path):
    jm = JModel(JConfig(**{**COMMON, **TINY}, dtype="f64"))
    jstate = js.bootstrap_state(js.consts_from_model(jm), jm)
    jstate = jstate._replace(step=np.int32(7), t=np.float64(0.007),
                             av=np.arange(8, dtype=np.float64))
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jstate, model=jm, t0=0.25)
    tm = SuperlatticeModel(SimConfig(**{**COMMON, **TINY}, dtype="f64"))
    mine, extra = tckpt.load_state(path, tm, device=CPU)
    got = ts.state_to_numpy(mine)
    for f in js.State._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    assert mine.step.dtype == torch.int32 and float(extra["t0"]) == 0.25
    wrong = SuperlatticeModel(SimConfig(**{**COMMON, **TINY}, dtype="f32"))
    with pytest.raises(ValueError, match="dtype"):
        tckpt.load_state(path, wrong)


def test_impl_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**{**COMMON, **TINY}, impl="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg.replace(impl="auto"), device="cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Simulation(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["display=4", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
                  "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10",
                  "PhiYmax=10", "B=0.1", "t-max=0.5", "g-grid=24",
                  "impl=cuda", "quiet=1", "o=stderr"])


@pytest.mark.parametrize("kw,what", [
    (dict(display=77), "display=77"),
    (dict(display=3), "display=3"),
    (dict(read_from="stdin"), "read-from=stdin"),
    (dict(resume="x.npz"), "resume="),
    (dict(warmup=True), "warmup"),
    (dict(shards=2), "shards>1"),
    (dict(exact_time=False), "exact-time=0"),
])
def test_unported_features_raise(kw, what):
    cfg = SimConfig(**{**COMMON, **TINY, **kw}, impl="torch")
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        Simulation(cfg, device=CPU)
    assert what in str(e.value)


def test_cli_torch_on_cpu_and_device_ordinal(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["display=4", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.5", "g-grid=24", "dtype=f64", "o=cli.txt"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv + ["impl=torch"]) == 0
    out = capsys.readouterr().out
    assert "# t_max = " in out and "[impl=torch]" in out
    rows = d4_values((tmp_path / "cli.txt").read_text())
    assert len(rows) == 1 and rows[0].shape == (13,)
    assert abs(rows[0][6] - 1.0) < 1e-3
    assert cli.main(argv + ["impl=xla"]) == 1        # JAX engine name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(argv + ["impl=cuda", "device=3"]) == 1
    assert "invalid device ordinal" in capsys.readouterr().err
