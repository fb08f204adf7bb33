"""Absorption map over an (E_dc, omega) grid — BASELINE config #5.

The port of ``examples/absorption_map.py``: for each drive point, run to
steady state and record the period-averaged drift velocity and absorption
A(omega), the whole grid as one sweep batch (parallel/sweep.py).

    python -m slb2d_tpu_torch.absorption_map [paper] [device=N|cpu]

The demo grid (7 E_dc x 5 omega, N=12, M=64) runs with impl=auto: on the
card, or on the CPU with device=cpu.  `paper` is the 16x16 map
(E_dc = linspace(0, 3, 16), omega = linspace(6, 14, 16), N=40, M=500,
t-max=5, E_omega=1.5) with impl=cuda: the sweep kernel's per-omega mode
on the card.  Prints the A and <v_dr> tables and names the engine.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def grid(paper: bool):
    """(config keywords, E_dc values, omega values) of the demo or the
    paper map, as examples/absorption_map.py sets them."""
    base = dict(display=4, E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0,
                alpha=0.9495, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
                dt=1e-3, quiet=True)
    if paper:
        return (dict(base, n_harmonics=40, t_start=5.0, g_grid=500,
                     impl="cuda"),
                np.linspace(0.0, 3.0, 16), np.linspace(6.0, 14.0, 16))
    return (dict(base, n_harmonics=12, t_start=2.0, g_grid=64, impl="auto"),
            np.linspace(0.0, 3.0, 7), np.linspace(6.0, 14.0, 5))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import config as cfgmod
    from .parallel.sweep import ParameterSweep

    kw, e_dc, omega = grid("paper" in argv)
    field, conv = cfgmod._KEYMAP["device"]
    try:
        for tok in argv:
            if tok.startswith("device="):
                kw[field] = conv(tok[len("device="):])
        cfg = cfgmod.SimConfig(**kw)
        device = cfgmod.torch_device(cfg)
    except (ValueError, RuntimeError) as e:   # a bad device=, no card
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    E, W = np.meshgrid(e_dc, omega, indexing="ij")
    B = E.size

    sweep = ParameterSweep(cfg, {"E_dc": E.ravel(), "omega": W.ravel()},
                           device=device)
    print(f"# {B} points x {sweep.n_steps} steps on {sweep.device} "
          f"[{sweep.engine} engine]", file=sys.stderr)
    wall0 = time.perf_counter()
    res = sweep.run()
    wall = time.perf_counter() - wall0
    sites = 2 * (cfg.n_harmonics + 1) * (cfg.g_grid + 1)
    print(f"# wall {wall:.2f}s; aggregate "
          f"{sites * sweep.n_steps * B / wall:.3e} site-updates/s",
          file=sys.stderr)

    A = res["A"].reshape(E.shape)
    v = res["v_dr_av"].reshape(E.shape)
    print("# absorption A(E_dc, omega):")
    print("# rows: E_dc = " + " ".join(f"{x:g}" for x in e_dc))
    print("# cols: omega = " + " ".join(f"{x:g}" for x in omega))
    for i in range(len(e_dc)):
        print(" ".join(f"{A[i, j]: .6e}" for j in range(len(omega))))
    print("# <v_dr>/v_p:")
    for i in range(len(e_dc)):
        print(" ".join(f"{v[i, j]: .6e}" for j in range(len(omega))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
