"""Command-line entry point: `slb2d-torch key=value ...` or
`python -m slb2d_tpu_torch.cli key=value ...` — the reference CLI surface
(reference: src/boltzmann_cli.c, README.md:30-66) plus the extensions
impl= (auto|torch|cuda|stream), dtype=, steps-per-chunk=, checkpoint=,
exact-time= and warmup=.
The run uses CUDA device `device=` (default 0) for every impl; only
device=cpu runs it on the CPU.  Without a CUDA device and without
device=cpu it prints an error and returns 1.  Unless quiet, the closing
`# perf:` line names the engine that ran: torch, cuda-b1 (the step
kernel) or stream (the temporal-tiling kernel).
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import config as cfgmod
    try:
        cfg = cfgmod.parse_cmd(argv)
    except cfgmod.ConfigError:
        return 1
    try:
        device = cfgmod.torch_device(cfg)
    except RuntimeError as e:       # no card, or no such card
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    from .runtime.loop import Simulation

    sim = Simulation(cfg, device=device)
    if cfg.warmup:
        sim.warmup()
    sim.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
