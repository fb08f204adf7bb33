"""The port's driver (runtime/loop.Simulation, cli, checkpoint) against the
JAX driver and the reference C solver's recorded output.

impl=torch runs on the CPU here, asked for with device=cpu (the port's
entry points run on the card otherwise).  f64 against the JAX Simulation at
rtol=1e-12 on all 13 display-4 columns (atol=1e-15 for columns that
cancel to ~0), headers byte for byte; the golden fixtures at
tests/test_golden.py's tolerances (f64 1e-8; f32 2e-5 with atol 8e-6, the
reference's own FMA-rebuild envelope, docs/DEVIATIONS.md D7).
"""

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel
from slb2d_tpu.ops import stencil as js
from slb2d_tpu.runtime import checkpoint as jckpt
from slb2d_tpu.runtime.loop import Simulation as JSimulation

from slb2d_tpu_torch import cli
from slb2d_tpu_torch import config as cfgmod
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


def test_display77_matches_jax_simulation_f64(tmp_path, monkeypatch):
    """Display 77 on impl=torch: the batched records (one fetch per
    chunk) against the JAX driver's lines, rtol 1e-12, t bit for bit."""
    kw = dict(TINY, display=77, t_start=0.2)
    port = run_port(tmp_path, monkeypatch, dtype="f64", **kw)
    JSimulation(JConfig(out_file="jax.txt", **{**COMMON, **kw},
                        dtype="f64")).run()
    ref = (tmp_path / "jax.txt").read_text()
    pl, rl = d4_values(port), d4_values(ref)
    assert len(pl) == len(rl) > 50 and pl[0].shape == (15,)
    for p, r in zip(pl, rl):
        assert p[13] == r[13]
        np.testing.assert_allclose(p, r, rtol=1e-12, atol=1e-15)
    assert headers(port) == headers(ref)


@pytest.mark.parametrize("dtype,grid,engine", [
    ("f32", (100, 4000), "cuda-b1"),     # BASELINE #4: B1 resident
    ("f32", (100, 12000), "cuda-b1"),
    ("f32", (400, 4000), "cuda-b1"),
    ("f64", (100, 12000), "stream"),     # B2 spill: faster than B1's
                                         # per-half-step form on a card
    ("f32", (8, 24), "cuda-b1"),
    ("f32", (31, 60000), "stream"),      # past the resident budget
])
def test_engine_routing(monkeypatch, dtype, grid, engine):
    """impl=cuda and auto take B1 wherever its resident form holds the
    state (the card ran it faster than B2 at all three measured shapes,
    PERF.md §6), else B2 where stream_beats_b1 says the card ran one of
    B2's forms faster than B1's per-half-step form (its spill form for the
    f32 and f64 grids its plan holds), B1 elsewhere; impl=stream forces B2,
    also on device=cpu (its plain version); impl=torch stays the tensor
    path.  Checked without building a model's device constants."""
    from slb2d_tpu_torch.ops.stepper_stream_cuda import stream_beats_b1
    N, M = grid
    cfg = SimConfig(**{**COMMON, **TINY, "n_harmonics": N, "g_grid": M},
                    dtype=dtype)

    def engine_of(impl, device):
        sim = Simulation.__new__(Simulation)
        sim.cfg = cfg.replace(impl=impl)
        sim.device = torch.device(device)
        sim.model = SuperlatticeModel(sim.cfg)
        return sim._select_engine()

    m = SuperlatticeModel(cfg)
    assert stream_beats_b1(m.NHP, m.MP, m.np_dtype) == (engine == "stream")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for impl in ("cuda", "auto"):
        assert engine_of(impl, "cuda:0") == engine
        with pytest.raises(ValueError, match="needs a CUDA device"):
            engine_of(impl, "cpu")
    assert engine_of("stream", "cuda:0") == "stream"
    assert engine_of("stream", "cpu") == "stream"
    assert engine_of("torch", "cuda:0") == engine_of("torch", "cpu") == \
        "torch"


def test_impl_cuda_without_cuda_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**{**COMMON, **TINY}, impl="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg.replace(impl="auto"), device="cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Simulation(cfg, device=CPU)
    # the CLI reports it and returns 1, naming the way to the CPU
    assert cli.main(["display=4", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
                     "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10",
                     "PhiYmax=10", "B=0.1", "t-max=0.5", "g-grid=24",
                     "impl=cuda", "quiet=1", "o=stderr"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("kw,what", [
    (dict(shards=2), "needs 2 devices, have 1"),
    (dict(shards=4, device="cpu"), "needs 4 devices, have 1"),
])
def test_unported_features_raise(kw, what):
    """shards>1, the last feature the driver did not run, is ported: a
    run now raises only where the mesh cannot be built (fewer devices
    than shards=, as the JAX driver raises), never NotImplementedError;
    with a mesh of CPU slots it runs (tests/test_torch_spatial.py)."""
    from slb2d_tpu_torch.parallel.mesh import make_mesh
    cfg = SimConfig(**{**COMMON, **TINY, **kw}, impl="torch")
    with pytest.raises(ValueError, match=what):
        Simulation(cfg, device=CPU if "device" not in kw else None)
    sim = Simulation(cfg, mesh=make_mesh((cfg.shards,), ("space",),
                                         devices=[CPU] * cfg.shards))
    assert sim.layout.S == cfg.shards


def test_cli_torch_on_cpu_and_device_ordinal(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["display=4", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.5", "g-grid=24", "dtype=f64", "o=cli.txt"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv + ["impl=torch"]) == 1       # the CPU only if asked
    assert "device=cpu" in capsys.readouterr().err
    assert cli.main(argv + ["impl=torch", "device=cpu"]) == 0
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


@pytest.mark.parametrize("impl", ["torch", "auto", "cuda"])
def test_simulation_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                             impl):
    """device=None means cuda:<cfg.device> for every impl, and only
    device=cpu the CPU: checked without running."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**{**COMMON, **TINY}, impl=impl, device=3)
    with pytest.raises(RuntimeError, match="cuda:3"):
        Simulation(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cfgmod.torch_device(cfg) == torch.device("cuda:3")
    assert cfgmod.torch_device(cfg.replace(device="cpu")) == CPU
    assert cfgmod.parse_cmd(["display=4", "E_dc=1", "E_omega=2",
                             "omega=10", "mu=1", "alpha=0.9495",
                             "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
                             "B=0.1", "t-max=0.5", "device=cpu"]).device \
        == "cpu"
    if impl == "torch":
        sim = Simulation(cfg.replace(device="cpu"))
        assert sim.device == CPU and sim.state.a.device == CPU


def test_fast_time_matches_jax_simulation_f64(tmp_path, monkeypatch):
    """exact-time=0 on impl=torch (trig on the device from the carried t,
    the av gate E_omega > 0 and t in [t_start, t_end) on the device)
    against JAX impl=xla exact-time=0, rtol 1e-12."""
    port = run_port(tmp_path, monkeypatch, dtype="f64", exact_time=False,
                    **TINY)
    JSimulation(JConfig(out_file="jax.txt", **{**COMMON, **TINY},
                        dtype="f64", impl="xla", exact_time=False)).run()
    ref = (tmp_path / "jax.txt").read_text()
    pl, rl = d4_values(port), d4_values(ref)
    assert len(pl) == len(rl) == 1 and pl[0].shape == (13,)
    np.testing.assert_allclose(pl[0], rl[0], rtol=1e-12, atol=1e-15)
    assert headers(port) == headers(ref)
    assert pl[0][3] != 0                      # the window averaged


def test_fast_time_leaves_display77_on_the_exact_tables(tmp_path,
                                                       monkeypatch):
    """Display 77 averages only at emission steps, which only the
    schedule's tables know: exact-time=0 does not change its output, as
    in the JAX package."""
    kw = dict(TINY, display=77, t_start=0.2, dtype="f32")
    exact = run_port(tmp_path, monkeypatch, **kw)
    fast = run_port(tmp_path, monkeypatch, exact_time=False, **kw)
    assert fast == exact and len(d4_values(fast)) > 50
    JSimulation(JConfig(out_file="jax.txt", **{**COMMON, **kw},
                        impl="xla", exact_time=False)).run()
    jax_fast = (tmp_path / "jax.txt").read_text()
    JSimulation(JConfig(out_file="jax.txt", **{**COMMON, **kw},
                        impl="xla")).run()
    assert jax_fast == (tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("impl,display", [("torch", 4), ("torch", 77),
                                          ("stream", 4)])
def test_warmup_leaves_the_output_unchanged(tmp_path, monkeypatch, impl,
                                           display):
    """warmup=1 through the CLI: the same output bytes and checkpoint as
    without it (it runs on a throwaway copy of the state)."""
    monkeypatch.chdir(tmp_path)
    argv = ["E_dc=1", "E_omega=2", "omega=10", "mu=1", "alpha=0.9495",
            "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10", "B=0.1",
            "t-max=0.2", "g-grid=24", "dtype=f32", "quiet=1", "device=cpu",
            f"impl={impl}", f"display={display}"]
    outs = []
    for extra in ([], ["warmup=1"]):
        name = f"w{len(outs)}"
        assert cli.main(argv + extra + [f"o={name}.txt",
                                        f"checkpoint={name}.npz"]) == 0
        outs.append(((tmp_path / f"{name}.txt").read_bytes(),
                     dict(np.load(tmp_path / f"{name}.npz"))))
    (text0, ck0), (text1, ck1) = outs
    assert text1 == text0 and len(text0) > 0
    assert ck0.keys() == ck1.keys()
    for k in ck0:
        np.testing.assert_array_equal(ck1[k], ck0[k], err_msg=k)


def test_warmup_runs_each_chunk_length_once(monkeypatch):
    """On impl=torch, warmup runs one chunk of each distinct length; on a
    kernel engine one chunk (a runner serves every length).  Checked by
    counting the chunk runs."""
    cfg = SimConfig(**{**COMMON, **TINY}, impl="torch", steps_per_chunk=100)
    sim = Simulation(cfg, device=CPU)
    runs = []
    monkeypatch.setattr(sim, "_run_chunk",
                        lambda st, chunk, parity: runs.append(
                            (chunk.n_steps, parity)) or (st, ()))
    state = sim.state
    sim.warmup()
    lengths = [n for n, _ in runs]
    assert len(lengths) == len(set(lengths)) == 2 and 100 in lengths
    assert sim.state is state and sim.steps_done == 0
    runs.clear()
    sim.engine = "stream"
    sim.warmup()
    assert runs == [(100, 0)]
