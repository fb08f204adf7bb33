"""slb2d_tpu_torch/dryrun.py, the port of __graft_entry__.py: the six
checks of dryrun_multichip in a fresh process with no environment
prepared (on the CPU here: 8 CPU slots, the kernels' plain versions),
entry()'s one step against the JAX entry's, and the device choice."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_fresh_process():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "SLB2D_"))}
    code = ("import sys\n"
            "from slb2d_tpu_torch.dryrun import dryrun_multichip\n"
            "dryrun_multichip(8)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'slb2d_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "dryrun_multichip OK: mesh=(4,2) of cpu B=8" in r.stdout


def test_entry_step_matches_jax_entry():
    """entry()'s one step on the CPU against the JAX entry's jitted step,
    from the same bootstrap, at BASELINE #4 (f32, 2e-4 / 2e-5 as
    tests/test_torch_sweep.py's XLA envelope)."""
    import __graft_entry__ as ge
    jfn, (jst,) = ge.entry()
    fn, (st,) = dryrun.entry(device="cpu")
    assert st.a.device.type == "cpu" and st.a.shape == (104, 4096)
    out, ref = fn(st), jax.jit(jfn)(jst)
    for f in ("a", "b", "a_hs", "b_hs", "av", "t", "step"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-4,
                                   atol=2e-5, err_msg=f)
    assert int(out.step) == 1


def test_dryrun_device_never_falls_back(monkeypatch):
    """No device given: the card where torch sees one, else the CPU; a
    card asked for that torch cannot see raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.dryrun_device() == torch.device("cpu")
    assert dryrun.dryrun_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda:0"):
        dryrun.dryrun_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dryrun.dryrun_device() == torch.device("cuda:0")
    with pytest.raises(RuntimeError, match="cuda:1"):
        dryrun.dryrun_device("cuda:1")
