"""The port's stdin parameter server (Simulation.run(repl_stream=...),
docs/DEVIATIONS.md D11) against the reference C solver's recorded
sessions and the JAX driver's REPL.

The port runs with device=cpu on impl=torch and on impl=stream, whose
runner (the stream kernel's plain version on the CPU) lives across every
round with new scalars.  Tolerances: the goldens at tests/test_golden.py's
(display 4: rtol 1e-8 atol 1e-12; display 77: rtol 5e-9 atol 1e-12),
headers byte for byte; against the JAX REPL at rtol 1e-12 with atol 1e-15,
headers byte for byte.  Each session is run once per module and engine
and shared by the tests that read it.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.runtime.loop import Simulation as JSimulation

from slb2d_tpu_torch import relaxation_repl
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.ops import stepper_cuda
from slb2d_tpu_torch.runtime.loop import Simulation

from tests.test_golden import COMMON, d4_values, read_gold

CPU = torch.device("cpu")
ENGINES = ["torch", "stream"]
TINY = dict(dtype="f64", n_harmonics=8, g_grid=24, omega=10.0,
            read_from="stdin")

# the three recorded sessions (tests/test_golden.py:233-300): golden file,
# display, t-max, script, tolerances against the golden
SESSIONS = {
    "repl": ("repl_f64.txt", 4, 0.5,
             "E_dc 1.5 0.5\nB 0.2 0.5\nmu 1.3 0.3\nomega 12.0 0.3\nexit\n",
             1e-8, 1e-12),
    "fuzz": ("repl_fuzz_f64.txt", 4, 0.5,
             "E_dc 1.5x 0.40\nbogus 7 0.30\nB .25e0 0.35\n"
             "exit 0.9 0.30\nmu abc 1.1 0.25\nexit\n", 1e-8, 1e-12),
    "d77": ("repl_d77_f64.txt.gz", 77, 0.3, "E_dc 1.6 0.2\nexit\n",
            5e-9, 1e-12),
}


def run_session(tmp_path, session, impl=None, jax=False):
    """(output text, Simulation) of one session in its own directory."""
    _, display, t_max, script, _, _ = SESSIONS[session]
    d = tmp_path / f"{session}-{'jax' if jax else impl}"
    d.mkdir()
    path = str(d / "out.txt")
    kw = {**COMMON, **TINY, "display": display, "t_start": t_max,
          "out_file": path}
    with contextlib.redirect_stdout(io.StringIO()):
        if jax:
            sim = JSimulation(JConfig(**kw, impl="xla"))
        else:
            sim = Simulation(SimConfig(**kw, impl=impl), device=CPU)
        sim.run(repl_stream=io.StringIO(script))
    with open(path) as fh:
        return fh.read(), sim


def headers(text):
    return [l for l in text.splitlines() if l.startswith("# display=")]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """sessions(session, impl or "jax"): (output text, Simulation), each
    run once per module."""
    root = tmp_path_factory.mktemp("repl")
    runs = {}

    def get(session, impl):
        if (session, impl) not in runs:
            runs[session, impl] = run_session(
                root, session, None if impl == "jax" else impl,
                jax=impl == "jax")
        return runs[session, impl]
    return get


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("session", list(SESSIONS))
def test_session_vs_reference(sessions, session, impl):
    gold_name, display, _, _, rtol, atol = SESSIONS[session]
    gold_text = read_gold(gold_name)
    mine, _ = sessions(session, impl)
    gold, got = d4_values(gold_text), d4_values(mine)
    assert len(gold) == len(got) == {4: 5, 77: len(gold)}[display]
    assert len(got) > (100 if display == 77 else 4)
    for g, m in zip(gold, got):
        assert g.shape == m.shape == ((13,) if display == 4 else (15,))
        np.testing.assert_allclose(m, g, rtol=rtol, atol=atol)
    assert headers(gold_text) == headers(mine)


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("session", list(SESSIONS))
def test_session_matches_jax_repl(sessions, session, impl):
    ref, _ = sessions(session, "jax")
    mine, _ = sessions(session, impl)
    rl, ml = d4_values(ref), d4_values(mine)
    assert len(rl) == len(ml) > 1
    for r, m in zip(rl, ml):
        if r.shape == (15,):
            assert m[13] == r[13]              # display-77 t bit for bit
        np.testing.assert_allclose(m, r, rtol=1e-12, atol=1e-15)
    assert [l for l in mine.splitlines() if l.startswith("#")] == \
           [l for l in ref.splitlines() if l.startswith("#")]


def test_one_runner_across_all_rounds(tmp_path, monkeypatch):
    """impl=stream keeps ONE runner object, its form and its buffers
    across the session: each mutation calls update_consts on it, whose
    host scalars carry the new E_dc, B and omega and the moved averaging
    window, while a0 and bdt stay at their startup values."""
    built, updates = [], []
    make = stepper_cuda.Runner.__init__
    update = stepper_cuda.Runner.update_consts

    def init(self, *a, **k):
        built.append(self)
        make(self, *a, **k)

    def upd(self, c_new):
        updates.append((self, dict(zip(stepper_cuda.SCALAR_FIELDS,
                                       (float(getattr(c_new, n)) for n in
                                        stepper_cuda.SCALAR_FIELDS)))))
        update(self, c_new)

    monkeypatch.setattr(stepper_cuda.Runner, "__init__", init)
    monkeypatch.setattr(stepper_cuda.Runner, "update_consts", upd)
    _, sim = run_session(tmp_path, "repl", "stream")
    assert len(built) == 1 and sim._runner is built[0]
    runner = built[0]
    # one update in the constructor, then one per mutation
    assert [u[0] for u in updates] == [runner] * 5
    first, *muts = [u[1] for u in updates]
    assert muts[0]["E_dc"] == 1.5 and muts[1]["B"] == 0.2
    assert muts[3]["omega"] == 12.0 and muts[2]["omega"] == 10.0
    assert all(m["bdt"] == first["bdt"] for m in muts)
    assert [m["t_start"] for m in muts] == sorted(
        {m["t_start"] for m in muts}) and muts[0]["t_start"] > first["t_start"]
    np.testing.assert_array_equal(sim.c.a0.numpy(),
                                  sim._runner.c.a0.numpy())
    assert float(sim.state.t) > muts[-1]["t_start"]
    # the runner's host scalars are those of the last mutation
    assert float(runner.params[stepper_cuda.SCALAR_FIELDS.index("omega")]) \
        == 12.0


def test_mutation_state_matches_jax(sessions):
    """After the session the port's scalar state equals the JAX driver's:
    t_start, t_max, t0, t_exit, the frozen a0 and bdt, av restarted."""
    _, jsim = sessions("repl", "jax")
    _, tsim = sessions("repl", "torch")
    for k in ("t_start", "t_max", "t0", "t_exit", "steps_done"):
        assert getattr(tsim, k) == getattr(jsim, k), k
    assert tsim.cfg.omega == jsim.cfg.omega == 12.0
    assert tsim.cfg.mu == jsim.cfg.mu == 1.3
    np.testing.assert_array_equal(tsim.model.a0, jsim.model.a0)
    assert tsim.model.bdt == jsim.model.bdt
    np.testing.assert_allclose(tsim.state.av.numpy(),
                               np.asarray(jsim.state.av), rtol=1e-12,
                               atol=1e-15)


def test_cli_reads_the_session_from_stdin(tmp_path, monkeypatch, capsys):
    """read-from=stdin on the CLI reads sys.stdin: the repl session's
    first mutation, its two display-4 lines and headers."""
    from slb2d_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("E_dc 1.5 0.5\nexit\n"))
    argv = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=10.0", "mu=1.0",
            "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
            "B=0.1", "t-max=0.5", "g-grid=24", "dtype=f64", "quiet=1",
            "read-from=stdin", "impl=torch", "device=cpu", "o=cli.txt"]
    assert cli.main(argv) == 0
    text = (tmp_path / "cli.txt").read_text()
    gold = read_gold("repl_f64.txt")
    assert len(d4_values(text)) == 2 and headers(text) == headers(gold)[:2]
    np.testing.assert_allclose(d4_values(text), d4_values(gold)[:2],
                               rtol=1e-8, atol=1e-12)


def test_relaxation_repl_runs(capsys):
    """The port of examples/relaxation_repl.py on the CPU: four display-4
    lines (the first round and three mutations), norms ~1, on impl=torch;
    without a card and without device=cpu it prints an error."""
    assert relaxation_repl.main(["device=cpu"]) == 0
    cap = capsys.readouterr()
    rows = [l.split() for l in cap.out.splitlines()
            if l and not l.startswith("#") and not l.startswith("E_")]
    rows = [r for r in rows if len(r) == 13]
    assert len(rows) == 4
    assert all(abs(float(r[6]) - 1.0) < 1e-3 for r in rows)
    assert "[torch]" in cap.err
    if not torch.cuda.is_available():
        assert relaxation_repl.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err
