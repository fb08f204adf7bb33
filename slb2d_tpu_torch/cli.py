"""Command-line entry point: `slb2d-torch key=value ...` or
`python -m slb2d_tpu_torch.cli key=value ...` — the reference CLI surface
(reference: src/boltzmann_cli.c, README.md:30-66) plus the extensions
impl= (auto|torch|cuda), dtype=, steps-per-chunk= and checkpoint=.
The run uses CUDA device `device=` (default 0); impl=torch runs on the
CPU when no CUDA device is present.
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

    import torch

    if cfg.impl == "torch" and not torch.cuda.is_available():
        device = torch.device("cpu")
    else:
        if torch.cuda.is_available() and not (
                0 <= cfg.device < torch.cuda.device_count()):
            # the reference aborts when cudaSetDevice fails
            # (src/boltzmann_solver.c:77 via HANDLE_ERROR :14)
            print(f"invalid device ordinal in {__file__}", file=sys.stderr)
            return 1
        device = torch.device(f"cuda:{cfg.device}")

    from .runtime.loop import Simulation

    Simulation(cfg, device=device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
