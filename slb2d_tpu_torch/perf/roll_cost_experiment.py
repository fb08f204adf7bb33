"""P2 on the card: what a neighbour read costs (csrc/probe_roll.cu).

The port of tests/perf/roll_cost_experiment.py's Pallas probes
``_kernel_two`` and ``_kernel_one``: K passes of ``x = x + roll(x, 1,
axis)`` (numpy's roll), form "two" over two (NH, MP) float32 arrays, form
"one" over the one stacked (2·NH, MP) array, along axis 1 (contiguous) and
axis 0 (strided by MP).  Two kernels answer the question on the H100:

  resident  one launch; a block holds whole lines along the rolled axis in
            shared memory and runs all K passes with a block barrier
            between them (the TPU kernel's design)
  passes    one launch per pass and array through L2 (B1's pattern: a
            kernel boundary as the barrier)

If form "one" costs about what "two" costs per pass, a neighbour read
costs per byte; if about half, per operation (per launch or per pass).

    python -m slb2d_tpu_torch.perf.roll_cost_experiment [K]

prints µs per pass for each kernel, axis and form, and one JSON line.  It
needs a card (main() refuses the CPU).  ``roll_resident`` and
``roll_passes`` run their kernel on CUDA tensors and the plain version,
``roll_plain``, on CPU tensors; nothing falls back.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from . import have_card, time_ms

NH, MP = 104, 4096
K = 2000
AXES = (1, 0)
FORMS = ("two", "one")
STRIP = 16                   # columns per block of the resident axis-0 kernel

# kernel launches made in this process, per kernel
resident_launch_count = 0
pass_launch_count = 0


def make_inputs(shape=(NH, MP)):
    """(x, y) as the probe makes them (RandomState(0) and (1))."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    y = np.random.RandomState(1).rand(*shape).astype(np.float32)
    return x, y


def roll_plain(arrays, axis, K):
    """The plain version: K passes of a = a + roll(a, 1, axis) on each
    array; returns new tensors."""
    import torch
    out = []
    for a in arrays:
        for _ in range(K):
            a = a + torch.roll(a, 1, axis)
        out.append(a)
    return out


def _check(arrays, axis, what):
    import torch
    if len(arrays) not in (1, 2) or axis not in AXES:
        raise ValueError(f"{what}: one or two arrays, axis 0 or 1")
    shape, dev = arrays[0].shape, arrays[0].device
    for a in arrays:
        if (a.dtype != torch.float32 or a.dim() != 2 or a.shape != shape
                or a.device != dev or not a.is_contiguous()):
            raise ValueError(f"{what}: the arrays must be contiguous 2-D "
                             f"float32 tensors of one shape on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def roll_resident(arrays, axis, K):
    """K passes over [x] (form "one") or [x, y] (form "two") in one
    launch of the resident kernel on CUDA tensors; the plain version on
    CPU tensors.  The inputs stay as they are; returns new tensors."""
    import torch
    dev = _check(arrays, axis, "roll_resident")
    if dev.type == "cpu":
        return roll_plain(arrays, axis, K)
    rows, cols = arrays[0].shape
    if axis == 0 and cols % STRIP:
        raise ValueError(f"roll_resident: axis 0 needs a multiple of "
                         f"{STRIP} columns, got {cols}")
    out = [a.clone() for a in arrays]
    from ..ops import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.cdll.slb_roll_resident_f32(
            out[0].data_ptr(), out[1].data_ptr() if len(out) == 2 else None,
            rows, cols, axis, int(K),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roll_resident kernel launch failed: "
                           f"cudaError_t {rc}")
    global resident_launch_count
    resident_launch_count += 1
    return out


def roll_passes(arrays, axis, K):
    """K passes over [x] or [x, y], one kernel launch per pass and array
    on CUDA tensors; the plain version on CPU tensors.  Returns new
    tensors."""
    import torch
    dev = _check(arrays, axis, "roll_passes")
    if dev.type == "cpu":
        return roll_plain(arrays, axis, K)
    rows, cols = arrays[0].shape
    bufs = [(a.clone(), torch.empty_like(a)) for a in arrays]
    ys = bufs[1] if len(bufs) == 2 else (None, None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    from ..ops import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.cdll.slb_roll_passes_f32(
            ptr(bufs[0][0]), ptr(bufs[0][1]), ptr(ys[0]), ptr(ys[1]), rows,
            cols, axis, int(K), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roll_passes kernel launch failed: cudaError_t "
                           f"{rc}")
    global pass_launch_count
    pass_launch_count += int(K) * len(arrays)
    return [b[int(K) % 2] for b in bufs]


KERNELS = {"resident": roll_resident, "passes": roll_passes}


def run(device, shape=(NH, MP), K=K, timed=3):
    """µs per pass of each kernel, axis and form at `shape` (form "one"
    stacks the two arrays) on `device` (the main path: one warm-up and
    `timed` timed calls each).  Returns records and, per kernel and axis,
    one/two: the ratio of the stacked form's time per pass to the two
    arrays'."""
    import torch
    x, y = (torch.from_numpy(a).to(device) for a in make_inputs(shape))
    inputs = {"two": [x, y], "one": [torch.cat([x, y], 0)]}
    records = []
    for kernel, fn in KERNELS.items():
        for axis in AXES:
            for form in FORMS:
                ms = time_ms(lambda: fn(inputs[form], axis, K), device,
                             timed)
                records.append(dict(kernel=kernel, axis=axis, form=form,
                                    us_per_pass=ms * 1e3 / K))
    t = {(r["kernel"], r["axis"], r["form"]): r["us_per_pass"]
         for r in records}
    ratio = {f"{k} axis {a}": t[k, a, "one"] / t[k, a, "two"]
             for k in KERNELS for a in AXES}
    return dict(shape=list(shape), K=K, records=records, one_over_two=ratio)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not have_card():
        return 1
    from ..bench import device_line
    passes = int(argv[0]) if argv else K
    card = device_line()
    res = run("cuda:0", K=passes)
    for r in res["records"]:
        print(f"{r['kernel']:8s} axis {r['axis']} form {r['form']}: "
              f"{r['us_per_pass']:.4f} us/pass")
    print("one/two per pass: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["one_over_two"].items())
        + f"; {NH}x{MP} float32 x2, K={passes} [{card}]")
    print(json.dumps({"probe": "P2 roll_cost_experiment", "device": card,
                      **res, "launches": {"resident": resident_launch_count,
                                          "passes": pass_launch_count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
