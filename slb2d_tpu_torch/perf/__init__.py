"""The JAX package's Pallas probes (tests/perf/) on the card, one module per
probe, each a hand-written CUDA kernel (csrc/probe_*.cu) beside its plain
PyTorch version:

  vpu_roofline           P1, the float32 elementwise ceiling that the
                         FP32 pipes sustain (PERF.md §6)
  roll_cost_experiment   P2, what a neighbour read costs: resident in
                         shared memory, or one launch per pass
  transposed_experiment  P3, B1's step in the transposed (m, n) layout

and two modules of measurements on the port's own kernels:

  stream_forms           B2's spill and tiling forms against each other
                         and B1's per-half-step form: the measurements
                         behind the spill plan's L2 budget, the tiling
                         form's width and impl=cuda's routing
  vs_parent              B1's resident form and B2's spill form against
                         the same forms in another checkout, in turns

Each runs as ``python -m slb2d_tpu_torch.perf.<name>`` on a card; its
main() refuses the CPU.  The functions take ``device=`` (and smaller
shapes), so the tests run the plain versions on the CPU.
"""

from __future__ import annotations

import subprocess
import sys
import time

# main()'s message where torch sees no card
NO_CARD = "no CUDA device: the probes run on a card only"


def time_ms(fn, device, reps=3):
    """ms per call of fn() after one warm-up call: CUDA events on a card,
    the host clock to the end of the last call on the CPU."""
    import torch
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def device_us(evt):
    """A torch.profiler event's device time in µs (the attribute was
    renamed across torch releases)."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def have_card() -> bool:
    """True where torch sees a CUDA device; else prints main()'s error."""
    import torch
    if torch.cuda.is_available():
        return True
    print(f"ERROR: {NO_CARD}", file=sys.stderr)
    return False


def with_clocks(fn, interval_ms=20):
    """(fn(), samples): fn runs while nvidia-smi samples card 0's SM clock
    (MHz) and power draw (W) every interval_ms; samples is a list of
    (MHz, W).  The sampler starts half a second before fn and is stopped
    after it."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", f"--loop-ms={interval_ms}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    samples = []
    for line in text.splitlines():
        try:
            mhz, watts = (float(v) for v in line.split(","))
        except ValueError:
            continue
        samples.append((mhz, watts))
    return out, samples


def clock_line(samples):
    """'SM clock a-b MHz (median c), power draw up to d W over n samples'."""
    if not samples:
        return "SM clock not sampled"
    mhz = sorted(s[0] for s in samples)
    return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
            f"{mhz[len(mhz) // 2]:.0f}), power draw up to "
            f"{max(s[1] for s in samples):.1f} W over {len(samples)} samples")
