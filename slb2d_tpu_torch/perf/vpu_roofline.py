"""P1 on the card: the float32 elementwise rate (csrc/probe_vpu.cu).

The port of tests/perf/vpu_roofline.py's Pallas probe (``bench_pallas``'s
``kernel``): a (NHP, MP) = (104, 4160) float32 array, the flagship padded
shape, every element running REPS turns of the K-step chain
``y = y * coef[i] + bias[i]`` with the array resident across the turns.
The kernel comes in two variants: a multiply and an add per chain step
(the rounding of the step kernels, built with -fmad=false), and one fused
multiply-add.  Operations are counted as the probe counts them,
NHP·MP·K·REPS chain steps: two operations each for the multiply and add,
one FMA (two flops) each for the fused variant.

    python -m slb2d_tpu_torch.perf.vpu_roofline [reps]

times both variants at every (ILP, block) pair it was built for and
prints a line per pair, the fastest of each variant with its share of the
data sheet's rate and of the FP32 pipes' rate at the highest SM clock
nvidia-smi sampled during the run, the SASS instruction counts of each
kernel (the whole function and its turn loop), and one JSON line.  It
needs a card (main() refuses the CPU).  CHOSEN holds the fastest pair
of each variant on an H100 (PERF.md §6).

``chain`` runs the kernel on a CUDA tensor and the plain version,
``chain_plain``, on a CPU one; nothing falls back.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np

from . import clock_line, have_card, time_ms, with_clocks

NHP, MP = 104, 4160          # the flagship padded shape (N=100, M=4000)
K = 64                       # chain steps per element and turn
REPS = 2000
ILPS = (2, 4)                # independent elements per thread
BLOCKS = (64, 128)
VARIANTS = ("mul+add", "fma")
# (ilp, block) per variant: ILP 2 for mul+add and ILP 4 for fma were the
# fastest in this module's sweeps on an H100 SXM at 700 W, blocks of 64 and
# 128 within 2% of each other (PERF.md, P1); ILP 1 and blocks of 256 were
# slower in an earlier build's sweep
CHOSEN = {"mul+add": (2, 64), "fma": (4, 64)}
# the FP32 lanes of an H100 SXM, 132 SMs of 128, and their rate at the
# data sheet's clock (67 TFLOP/s, an FMA counted as two)
FP32_LANES = 132 * 128
DATA_SHEET_OPS = 67e12 / 2
# instructions of a turn loop besides its chain: counter, compare, branch
LOOP_CONTROL = 3

# kernel launches made in this process
launch_count = 0


def make_coeffs(shape=(NHP, MP)):
    """(coef, bias, x) as the probe makes them (numpy default_rng(0)); a
    smaller shape takes the leading rows and columns of the full x."""
    rng = np.random.default_rng(0)
    coef = rng.uniform(0.99, 1.01, size=(K,)).astype(np.float32)
    bias = rng.uniform(-1e-6, 1e-6, size=(K,)).astype(np.float32)
    x = rng.standard_normal((NHP, MP)).astype(np.float32)
    return coef, bias, np.ascontiguousarray(x[:shape[0], :shape[1]])


def chain_plain(x, coef, bias, reps, fma=False):
    """The plain version: reps turns of the chain as tensor operations.
    mul+add rounds the product and the sum each to float32, as the
    kernel's __fmul_rn and __fadd_rn; fma rounds once: the float32
    product is exact in float64, and so is its sum with the bias wherever
    the two lie within 2^29 of each other (every value of the probe's
    inputs), so float64 arithmetic rounded to float32 is __fmaf_rn's
    result."""
    import torch
    c = [float(v) for v in coef]
    b = [float(v) for v in bias]
    y = x.clone()
    if fma:
        y = y.double()
    for _ in range(reps):
        for k in range(K):
            y = y * c[k] + b[k]
            if fma:
                y = y.float().double()
    return y.to(torch.float32)


def chain(x, coef, bias, reps, fma=False, ilp=2, block=64):
    """reps turns of the chain over float32 x: the kernel (one launch) on
    a CUDA tensor, the plain version on a CPU tensor.  coef and bias are
    K float32 values each (numpy, or tensors on x's device)."""
    import torch
    if x.device.type == "cpu":
        return chain_plain(x, coef, bias, reps, fma)
    if x.device.type != "cuda":
        raise ValueError(f"vpu_chain: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"vpu_chain: x must be a contiguous float32 "
                         f"tensor, got {x.dtype}")
    if ilp not in ILPS or block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"vpu_chain: ilp {ilp} (one of {ILPS}) or block "
                         f"{block} (a multiple of 32 up to 1024)")
    coef, bias = (torch.as_tensor(v, dtype=torch.float32,
                                  device=x.device).contiguous()
                  for v in (coef, bias))
    if coef.shape != (K,) or bias.shape != (K,):
        raise ValueError(f"vpu_chain: coef and bias must hold {K} values")
    from ..ops import _build
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.cdll.slb_vpu_chain_f32(
            x.data_ptr(), y.data_ptr(), coef.data_ptr(), bias.data_ptr(),
            x.numel(), int(reps), ilp, int(fma), block,
            torch.cuda.current_stream(x.device).cuda_stream)
    # coef and bias may be freed before the launch runs: the caching
    # allocator hands their memory only to later work on this stream
    if rc != 0:
        raise RuntimeError(f"vpu_chain kernel launch failed: cudaError_t "
                           f"{rc}")
    global launch_count
    launch_count += 1
    return y


def rate(variant, ms, n, reps):
    """Operations per second of one call: two per chain step for mul+add,
    one FMA per chain step for fma."""
    steps = n * K * reps
    return (2 * steps if variant == "mul+add" else steps) / (ms * 1e-3)


def run(device, shape=(NHP, MP), reps=REPS, timed=3, configs=None):
    """Time both variants at each (ILP, block) pair of `configs`, {variant:
    [(ilp, block), ...]} (every pair of ILPS and BLOCKS by default), on
    `device` (the main path: one warm-up and `timed` timed calls each).
    Returns the records and, per variant, the fastest: mul+add in
    operations per second, fma in FMAs per second."""
    import torch
    if configs is None:
        configs = {v: [(i, b) for i in ILPS for b in BLOCKS]
                   for v in VARIANTS}
    coef, bias, x = make_coeffs(shape)
    xt = torch.from_numpy(x).to(device)
    coef_t, bias_t = (torch.from_numpy(v).to(device) for v in (coef, bias))
    n = xt.numel()
    records = []
    for variant in VARIANTS:
        for ilp, block in configs[variant]:
            ms = time_ms(lambda: chain(xt, coef_t, bias_t, reps,
                                       fma=variant == "fma", ilp=ilp,
                                       block=block), device, timed)
            records.append(dict(variant=variant, ilp=ilp, block=block,
                                ms=ms, rate=rate(variant, ms, n, reps)))
    best = {v: max((r for r in records if r["variant"] == v),
                   key=lambda r: r["rate"]) for v in VARIANTS}
    return dict(shape=list(shape), reps=reps, K=K, records=records,
                best=best, rate=best["mul+add"]["rate"],
                fma_rate=best["fma"]["rate"])


def pipe_rate(samples):
    """The FP32 pipes' rate, one multiply or add per lane and cycle, at
    the highest SM clock of with_clocks' samples, so no faster than the
    pipes ran during them (the idle clock of the samples before the work
    starts would understate it); None without samples."""
    if not samples:
        return None
    return FP32_LANES * max(s[0] for s in samples) * 1e6


def _op_counts(instrs):
    out = {op: 0 for op in ("FMUL", "FADD", "FFMA")}
    for _, text in instrs:
        m = re.search(r"\b(FMUL|FADD|FFMA)\b", text)
        if m:
            out[m.group(1)] += 1
    out["all"] = len(instrs)
    return out


def sass_listing(text):
    """{function: (instructions, labels)} from cuobjdump -sass output: each
    function's (address, instruction) pairs and its branch labels'
    addresses."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = ([], {}, [])      # instructions, labels, pending
            continue
        if name is None:
            continue
        instrs, labels, pending = funcs[name]
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((label, addr) for label in pending)
            pending.clear()
            instrs.append((addr, m.group(2).strip()))
    return {k: (instrs, labels) for k, (instrs, labels, _) in funcs.items()}


def sass_loops(instrs, labels):
    """A function's loops as (first, last) addresses: each backward
    branch and the instruction it jumps to."""
    loops = []
    for addr, text in instrs:
        if not re.search(r"\bBRA\b", text):
            continue
        m = re.search(r"\((\.L_x_\d+)\)", text)
        h = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        target = (labels.get(m.group(1)) if m
                  else int(h.group(1), 16) if h else None)
        if target is not None and target < addr:
            loops.append((target, addr))
    return loops


def sass_functions(text):
    """{function: counts} from cuobjdump -sass output: FMUL, FADD, FFMA
    and all instructions ("all") in the whole function, and under "loop"
    the same in its longest loop, the instructions from a backward
    branch's target to the branch."""
    out = {}
    for name, (instrs, labels) in sass_listing(text).items():
        loop = []
        for first, last in sass_loops(instrs, labels):
            body = [i for i in instrs if first <= i[0] <= last]
            loop = max(loop, body, key=len)
        out[name] = {**_op_counts(instrs), "loop": _op_counts(loop)}
    return out


def sass_counts(lib_path):
    """sass_functions' counts of each vpu_chain instance of the built
    library, by "mul+add ilp=I" or "fma ilp=I", through cuobjdump -sass
    (the toolkit's, beside nvcc)."""
    from ..ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {}
    for name, c in sass_functions(text).items():
        k = re.search(r"vpu_chainILi(\d)ELb([01])E", name)
        if k:
            counts[f"{VARIANTS[int(k.group(2))]} ilp={k.group(1)}"] = c
    return counts


def check_sass(counts):
    """Raise unless every instance's turn loop is its chain and the loop
    control alone: K·ILP each of FMUL and FADD and no FFMA for mul+add,
    K·ILP FFMA for fma, and LOOP_CONTROL other instructions."""
    for ilp in ILPS:
        for variant, want in (("mul+add", {"FMUL": K * ilp, "FADD": K * ilp,
                                           "FFMA": 0}),
                              ("fma", {"FMUL": 0, "FADD": 0,
                                       "FFMA": K * ilp})):
            c = counts.get(f"{variant} ilp={ilp}")
            loop = c and c["loop"]
            if (not loop or any(loop[op] != n for op, n in want.items())
                    or loop["all"] != sum(want.values()) + LOOP_CONTROL):
                raise RuntimeError(f"vpu_chain SASS, {variant} ilp={ilp}: "
                                   f"{c}")


def sass_line(counts):
    """'<instance>: loop FMUL a FADD b FFMA c of n (function ...)' per
    instance."""
    def ops(c):
        return (f"FMUL {c['FMUL']} FADD {c['FADD']} FFMA {c['FFMA']} of "
                f"{c['all']}")
    return "; ".join(f"{k}: loop {ops(v['loop'])} (function {ops(v)})"
                     for k, v in sorted(counts.items()))


def shares_line(rate, samples):
    """'a of the data sheet's, b of the pipes' at the highest sampled
    clock'."""
    pipe = pipe_rate(samples)
    return (f"{rate / DATA_SHEET_OPS:.4f} of the data sheet's "
            f"{DATA_SHEET_OPS:.4g}" +
            (f", {rate / pipe:.4f} of the pipes' {pipe:.4e} at the highest "
             f"sampled SM clock" if pipe else ""))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not have_card():
        return 1
    from ..bench import device_line
    from ..ops import _build
    reps = int(argv[0]) if argv else REPS
    card = device_line()
    res, samples = with_clocks(lambda: run("cuda:0", reps=reps))
    for r in res["records"]:
        unit = "op/s" if r["variant"] == "mul+add" else "FMA/s"
        print(f"vpu_chain {r['variant']:7s} ilp={r['ilp']} block="
              f"{r['block']:4d}: {r['ms']:.4f} ms, {r['rate']:.4e} {unit}")
    counts = sass_counts(_build.load().path)
    check_sass(counts)
    mb, fb = res["best"]["mul+add"], res["best"]["fma"]
    print(f"fastest: mul+add {res['rate']:.4e} op/s (ilp={mb['ilp']} "
          f"block={mb['block']}; {shares_line(res['rate'], samples)}), fma "
          f"{res['fma_rate']:.4e} FMA/s = {2 * res['fma_rate']:.4e} flop/s "
          f"(ilp={fb['ilp']} block={fb['block']}; "
          f"{shares_line(res['fma_rate'], samples)}); {NHP}x{MP} float32, "
          f"K={K}, reps={reps}; {clock_line(samples)} [{card}]")
    print("SASS: " + sass_line(counts))
    print(json.dumps({"probe": "P1 vpu_roofline", "device": card,
                      "rate_op_s": res["rate"],
                      "fma_per_s": res["fma_rate"],
                      "pipe_rate_op_s": pipe_rate(samples),
                      "best": res["best"], "sass": counts,
                      "clocks_mhz_w": samples,
                      "launches": launch_count}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
