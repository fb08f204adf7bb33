"""Absorption-map sweep over several processes (the port of
examples/multihost_sweep.py).

The sweep mesh spans processes: the same ParameterSweep call that runs a
grid on one device spreads it over every slot of every process.  Launch
one copy per process with the JAX example's variables, or with torchrun:

    SLB2D_COORD=host0:8476 SLB2D_NPROCS=2 SLB2D_PROC_ID=k \\
        python -m slb2d_tpu_torch.multihost_sweep [device=cpu]
    torchrun --nproc-per-node=2 -m slb2d_tpu_torch.multihost_sweep

Without either it runs in one process.  Every process receives the whole
table (ParameterSweep allgathers it); process 0 prints it.  `device=cpu`
runs on the CPU, one slot a process; else on the cards of
parallel/mesh.local_devices.
SLB2D_POINTS_PER_DEV sets the points per slot (default 4).
"""

import os
import sys

import numpy as np

from .config import SimConfig
from .parallel.mesh import (init_distributed, make_mesh, process_count,
                            process_index)
from .parallel.sweep import ParameterSweep
from .sweep_cli import HEADER


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "device=cpu" in argv else 0
    init_distributed()
    cfg = SimConfig(
        display=4, E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0, alpha=0.9495,
        n_harmonics=12, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
        t_start=2.0, g_grid=100, dt=1e-3, quiet=True, device=device)
    mesh = make_mesh(None, ("sweep",), cfg=cfg)
    n_dev = mesh.size
    if process_index() == 0:
        print(f"# {process_count()} process(es), {n_dev} global "
              f"device(s)", file=sys.stderr)
    B = n_dev * int(os.environ.get("SLB2D_POINTS_PER_DEV", "4"))
    e_dcs = np.linspace(0.1, 3.0, B)
    res = ParameterSweep(cfg, {"E_dc": e_dcs},
                         mesh=mesh if n_dev > 1 else None).run()
    if process_index() == 0:
        sys.stdout.write(HEADER)
        for i in range(B):
            vals = [e_dcs[i], cfg.E_omega, cfg.omega, cfg.mu, cfg.alpha,
                    cfg.B]
            obs = [res[k][i] for k in (
                "v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin",
                "v_dr_inst", "v_y_inst", "m_over_m_x_inst", "norm")]
            sys.stdout.write(
                " ".join(f"{float(v):.12e}" for v in vals + obs) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
