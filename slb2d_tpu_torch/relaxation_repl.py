"""Relaxation study through the interactive parameter server.

The port of ``examples/relaxation_repl.py``, the reference's signature
workflow (src/boltzmann_cli.c:71-91): run to a steady state, print the
display-4 observable line, then mutate ONE drive parameter and continue
from the LIVE distribution (it is never reset), letting the system relax
for `timeout` before averaging restarts.

    python -m slb2d_tpu_torch.relaxation_repl [device=N|cpu] [impl=...]

The distribution stays on the device across mutations, and a kernel
engine keeps its runner: only the scalars it reads at each launch change.
impl= defaults to auto (the card); device=cpu runs impl=torch on the CPU
unless impl= is given.
"""

from __future__ import annotations

import io
import sys

ARGV = ["display=4", "E_dc=0.5", "E_omega=1.5", "omega=10.0", "mu=1.0",
        "alpha=0.9495", "n-harmonics=12", "PhiYmin=-8", "PhiYmax=8",
        "B=0.1", "t-max=0.6", "g-grid=64", "dt=0.001", "quiet=1",
        "read-from=stdin", "o=stdout"]

# protocol: "name value timeout" per round, "exit" to stop — exactly what
# the reference's scan_for_new_parameters reads
SCRIPT = ("E_dc 1.0 0.3\n"
          "E_dc 1.5 0.3\n"
          "B    0.3 0.3\n"
          "exit\n")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import config as cfgmod
    from .runtime.loop import Simulation

    extra = [a for a in argv if a.startswith(("device=", "impl="))]
    if "device=cpu" in extra and not any(a.startswith("impl=")
                                         for a in extra):
        extra.append("impl=torch")
    try:
        cfg = cfgmod.parse_cmd(ARGV + extra)
    except cfgmod.ConfigError:
        return 1
    try:
        device = cfgmod.torch_device(cfg)
    except RuntimeError as e:       # no card, or no such card
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print("# relaxation study: each line below is one steady state; the "
          "distribution persists across parameter changes", file=sys.stderr)
    sim = Simulation(cfg, device=device)
    sim.run(repl_stream=io.StringIO(SCRIPT))
    print(f"# {sim.steps_done} steps on {sim.device} "
          f"[{sim.engine_tag()}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
