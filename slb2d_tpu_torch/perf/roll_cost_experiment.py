"""P2 on the card: what a neighbour read costs (csrc/probe_roll.cu).

The port of tests/perf/roll_cost_experiment.py's Pallas probes
``_kernel_two`` and ``_kernel_one``: K passes of ``x = x + roll(x, 1,
axis)`` (numpy's roll), form "two" over two (NH, MP) float32 arrays, form
"one" over the one stacked (2·NH, MP) array, along axis 1 (contiguous) and
axis 0 (strided by MP).  Two kernels answer the question on the H100:

  registers  one launch; every line of the rolled axis in registers, V
             elements a thread, the neighbour by a shuffle: a line in
             one warp (``warp``, no barrier), or across the warps of a
             block with a T-element halo exchanged through shared memory
             behind one barrier every T passes (``halo``);
             ``register_plan`` picks the form by the line's length
             (the halo form at V=17, T=32, the fastest of four timed).
             It replaced the TPU kernel's design, a block holding whole
             lines in shared memory with a barrier every pass, which was
             about 15x slower on an H100 at the probe's shape
  passes     one launch per pass and array through L2 (B1's pattern: a
             kernel boundary as the barrier)

If form "one" costs about what "two" costs per pass, a neighbour read
costs per byte; if about half, per operation (per launch or per pass).
``exchange_us`` prices the three exchanges a resident step can choose
between: a shuffle, shared memory with a block barrier, a launch.

    python -m slb2d_tpu_torch.perf.roll_cost_experiment [K]

prints µs per pass for each kernel, axis and form, the exchange costs,
and one JSON line.  It needs a card
(main() refuses the CPU).  ``roll_registers`` and ``roll_passes`` run
their kernel on CUDA tensors and the plain version, ``roll_plain``, on CPU
tensors; nothing falls back.
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
# The register kernels' instances (csrc/probe_roll.cu
# slb_roll_registers_f32): the elements a lane of roll_reg_warp holds, and
# roll_reg_halo's (V, T)
WARP_VS = (1, 4, 13)
HALO = (17, 32)
KINDS = {"warp": 0, "halo": 1}

# kernel launches made in this process, per kernel
register_launch_count = 0
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


def register_plan(L):
    """The register kernel's (kind, V, T) for lines of L elements, or
    None: roll_reg_warp with the fewest elements a lane of WARP_VS where
    the line fits one warp's lanes, else roll_reg_halo where HALO cuts the
    line into at most 32 warps (L=104: ("warp", 13, 0), 8 lanes a line;
    L=208: 16 lanes; L=4096: ("halo", 17, 32), 8 warps of 512)."""
    for V in WARP_VS:
        P = L // V
        if L % V == 0 and P <= 32 and P & (P - 1) == 0:
            return "warp", V, 0
    V, T = HALO
    S = 32 * V - T
    if L % S == 0 and L // S <= 32:
        return "halo", V, T
    return None


def roll_registers(arrays, axis, K, every=None):
    """K passes over [x] (form "one") or [x, y] (form "two") in one launch
    of register_plan's kernel on CUDA tensors, the halo form's halo
    refreshed every `every` passes (1 <= every <= T, default T; the warp
    form has none); the plain version on CPU tensors.  Lines no kernel
    takes, or an `every` it would refuse, raise on either device.  The
    inputs stay as they are; returns new tensors."""
    import torch
    dev = _check(arrays, axis, "roll_registers")
    rows, cols = arrays[0].shape
    L = cols if axis == 1 else rows
    plan = register_plan(L)
    if plan is None:
        raise ValueError(f"roll_registers: no register kernel takes lines "
                         f"of {L}")
    kind, V, T = plan
    if kind == "warp" and every is not None:
        raise ValueError(f"roll_registers: lines of {L} take the warp "
                         f"form, which has no halo to refresh")
    every = T if every is None else int(every)
    if kind == "halo" and not 1 <= every <= T:
        raise ValueError(f"roll_registers: every={every} is not in 1..{T}")
    if dev.type == "cpu":
        return roll_plain(arrays, axis, K)
    out = [a.clone() for a in arrays]
    from ..ops import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.cdll.slb_roll_registers_f32(
            out[0].data_ptr(), out[1].data_ptr() if len(out) == 2 else None,
            rows, cols, axis, int(K), KINDS[kind], V, T, every,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roll_registers kernel launch failed: "
                           f"cudaError_t {rc}")
    global register_launch_count
    register_launch_count += 1
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


KERNELS = {"registers": roll_registers, "passes": roll_passes}


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


def exchange_us(device, shape=(NH, MP), K=K, timed=3):
    """µs per pass of form two along axis 1 at `shape`, in mirrored turns:
    the register kernel with the halo refreshed every T passes (a shuffle a
    pass, a shared-memory exchange and a barrier every T) and every pass
    (both a pass), and the per-pass kernel (a launch a pass and array).
    Returns {name: [µs per pass]}."""
    import torch
    x, y = (torch.from_numpy(a).to(device) for a in make_inputs(shape))
    T = HALO[1]
    fns = {f"every={every}": (lambda every=every: roll_registers(
        [x, y], 1, K, every=every)) for every in (T, 1)}
    fns["passes"] = lambda: roll_passes([x, y], 1, K)
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(time_ms(fns[k], device, timed) * 1e3 / K)
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not have_card():
        return 1
    from ..bench import device_line
    passes = int(argv[0]) if argv else K
    card = device_line()
    res = run("cuda:0", K=passes)
    for r in res["records"]:
        print(f"{r['kernel']:9s} axis {r['axis']} form {r['form']}: "
              f"{r['us_per_pass']:.4f} us/pass")
    print("one/two per pass: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["one_over_two"].items())
        + f"; {NH}x{MP} float32 x2, K={passes} [{card}]")
    launches = {"registers": register_launch_count,
                "passes": pass_launch_count}
    ex = exchange_us("cuda:0", K=passes)
    print("exchange, form two axis 1, us per pass in turns: " + "; ".join(
        f"{k} " + "/".join(f"{v:.4f}" for v in vs) for k, vs in ex.items()))
    print(json.dumps({"probe": "P2 roll_cost_experiment", "device": card,
                      **res, "exchange_us": ex, "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
