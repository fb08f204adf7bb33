"""Command-line entry point: `slb2d-torch key=value ...` or
`python -m slb2d_tpu_torch.cli key=value ...` — the reference CLI surface
(reference: src/boltzmann_cli.c, README.md:30-66: displays 3, 4, 7, 8,
9 and 77, read-from=stdin) plus the extensions impl=
(auto|torch|cuda|stream), dtype=, steps-per-chunk=, checkpoint=,
resume=, frame-batch=, exact-time=, warmup= and profile-dir= (the run
under torch.profiler, its Chrome trace written under DIR).
The run uses CUDA device `device=` (default 0) for every impl; only
device=cpu runs it on the CPU.  Without a CUDA device and without
device=cpu, or with fewer devices than shards= (the CPU is one device,
parallel/mesh.local_devices), it prints an error and returns 1.  Unless
quiet, the closing `# perf:` line names the engine that ran: torch, cuda-b1 resident or
cuda-b1 per-half-step (the step kernel in the form it took) or stream
(the temporal-tiling kernel).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


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

    try:
        sim = Simulation(cfg, device=device)
    except ValueError as e:     # e.g. fewer devices than shards=
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if cfg.warmup:
        sim.warmup()
    with profiled(cfg.profile_dir, device):
        sim.run()
    return 0


@contextlib.contextmanager
def profiled(profile_dir, device):
    """Run the block under torch.profiler when profile_dir is set (the JAX
    CLIs trace the same block with jax.profiler): CPU activity, and CUDA
    activity on a card.  The Chrome trace goes to
    profile_dir/slb2d_torch_<pid>_<ns>.pt.trace.json."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"slb2d_torch_{os.getpid()}_{time.time_ns()}"
                     f".pt.trace.json"))


if __name__ == "__main__":
    sys.exit(main())
