"""B1's resident form, B2's spill form and B3's cluster form against the
same forms in another checkout of this repository, on one card, in
turns.

    python -m slb2d_tpu_torch.perf.vs_parent DIR

DIR is the other checkout (say a `git archive` of the commit compared
with, unpacked in a directory git ignores).  Its slb2d_tpu_torch package
is imported beside this one as slb2d_parent, and its kernels build on
first use as its own _build builds them: into DIR/build/slb2d_tpu_torch,
so the tool leaves that build output in the other checkout.  Each shape
runs STEPS steps in one chunk in f32 at BASELINE #4's physics, timed per
step with CUDA events (perf.time_ms) in turns: this checkout, the other,
the other, this one.
After the four turns the two checkouts' states must be equal bit for bit.
The shapes: B1's resident form at N=7 M=4000 (where the cells cost next to
nothing: its fixed cost a step), N=100 M=4000 (BASELINE #4) and N=400
M=4000, B2's spill form at N=100 M=20000, and B3's cluster form at N=40
M=500 on the benchmark's two maps: the 16 x 16 paper map per omega (256
points) and the 64-point E_dc sweep at one omega.  A B3 turn advances
each checkout's own sweep from where its last turn left it, by an eighth
of the sweep's steps (both see the same steps in the same order).  It
prints one line per shape and one JSON line, and needs a card (main()
refuses the CPU).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

import numpy as np

from . import have_card, time_ms
from .stream_forms import PHYS, STEPS, setup

# (name, N, M, engine, form)
SHAPES = (("B1 resident N=7 M=4000", 7, 4000, "b1", "resident"),
          ("B1 resident N=100 M=4000", 100, 4000, "b1", "resident"),
          ("B1 resident N=400 M=4000", 400, 4000, "b1", "resident"),
          ("B2 spill N=100 M=20000", 100, 20000, "b2", "spill"),
          ("B3 cluster paper map", 40, 500, "b3", "omega"),
          ("B3 cluster edc64", 40, 500, "b3", "shared"))
# B3's sweeps (config keywords, params): the paper map, absorption_map.py
# paper's 16 E_dc x 16 omega at t-max=5, and the 64-point E_dc sweep of
# the bench at one drive period
_E, _W = np.meshgrid(np.linspace(0.0, 3.0, 16), np.linspace(6.0, 14.0, 16),
                     indexing="ij")
SWEEPS = {"omega": ({**PHYS, "E_dc": 0.0, "E_omega": 1.5, "t_start": 5.0},
                    {"E_dc": _E.ravel(), "omega": _W.ravel()}),
          "shared": ({**PHYS, "t_start": 0.1},
                     {"E_dc": np.linspace(0.1, 3.0, 64)})}
USAGE = ("usage: python -m slb2d_tpu_torch.perf.vs_parent DIR (a checkout "
         "of this repository, with its slb2d_tpu_torch/)")


def load_parent(root):
    """The runner makers of the slb2d_tpu_torch package in the checkout at
    `root`, imported as slb2d_parent: {"b1": make_cuda_runner, "b2":
    make_stream_runner, "b3": sweep_maker("slb2d_parent")}."""
    if "slb2d_parent" not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "slb2d_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "slb2d_parent", os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["slb2d_parent"] = mod
        spec.loader.exec_module(mod)
    return {"b1": importlib.import_module(
                "slb2d_parent.ops.stepper_cuda").make_cuda_runner,
            "b2": importlib.import_module(
                "slb2d_parent.ops.stepper_stream_cuda").make_stream_runner,
            "b3": sweep_maker("slb2d_parent")}


def sweep_maker(pkg):
    """make(mode, N, M, device) -> (sweep, B3 runner) of SWEEPS[mode] at N,
    M in f32, from package `pkg`'s own SimConfig, ParameterSweep and
    SweepStackRunner."""
    def make(mode, N, M, device):
        import torch
        cfg_mod = importlib.import_module(pkg + ".config")
        sweep_mod = importlib.import_module(pkg + ".parallel.sweep")
        ssc = importlib.import_module(pkg + ".ops.sweep_stack_cuda")
        kw, params = SWEEPS[mode]
        cfg = cfg_mod.SimConfig(display=4, dtype="f32", impl="cuda",
                                quiet=True, n_harmonics=N, g_grid=M, **kw)
        sweep = sweep_mod.ParameterSweep(cfg, params,
                                         device=torch.device(device))
        return sweep, ssc.SweepStackRunner(sweep)
    return make


def _b3_turns(makers, mode, N, M, device, reps):
    """{"this": [µs a step], "parent": [...]} of B3 on SWEEPS[mode] in
    turns, and the two checkouts' final states."""
    sweeps, runners = {}, {}
    for k, m in makers.items():
        sweeps[k], runners[k] = m["b3"](mode, N, M, device)
        if runners[k].form != "cluster":
            raise RuntimeError(f"B3 {mode}: the {runners[k].form} form in "
                               f"{k}")
    # 2 turns a side of a warm-up and reps advances of n steps each
    n = sweeps["this"].n_steps // (2 * (reps + 1))
    states = {k: s._initial_states() for k, s in sweeps.items()}
    caps = {k: s._zero_cap() for k, s in sweeps.items()}

    def go(k):
        if runners[k].per_omega:
            states[k], caps[k] = runners[k].advance(states[k], n,
                                                    cap=caps[k])
        else:
            states[k] = runners[k].advance(states[k], n)
    t = {k: [] for k in makers}
    for k in ("this", "parent", "parent", "this"):
        t[k].append(1e3 * time_ms(lambda: go(k), device, reps) / n)
    return t, states


def _turns(makers, N, M, engine, form, device, n, reps):
    """{"this": [µs a step], "parent": [...]} of B1 or B2 in `form` over n
    steps of one chunk in turns, and the two checkouts' final states."""
    from ..ops import stencil
    model, c, xs = setup(N, M, "f32", device)
    win = {k: v[:n] for k, v in xs.items()}
    runners = {k: m[engine](c, model, form=form) for k, m in makers.items()}
    state0 = stencil.bootstrap_state(c, model)
    states = {k: state0.clone() for k in runners}
    t = {k: [] for k in runners}
    for k in ("this", "parent", "parent", "this"):
        t[k].append(1e3 * time_ms(
            lambda: runners[k].run_xs(states[k], win, 0), device, reps) / n)
    return t, states


def compare(root, device="cuda:0", n=STEPS, reps=3):
    """{shape: {"this": [µs a step], "parent": [µs a step]}} of SHAPES in
    turns; raises where the two checkouts' states differ."""
    import torch
    from ..ops import stepper_cuda, stepper_stream_cuda as sst
    makers = {"this": {"b1": stepper_cuda.make_cuda_runner,
                       "b2": sst.make_stream_runner,
                       "b3": sweep_maker(__package__.rpartition(".")[0])},
              "parent": load_parent(root)}
    out = {}
    for name, N, M, engine, form in SHAPES:
        if engine == "b3":
            t, states = _b3_turns(makers, form, N, M, device, reps)
        else:
            t, states = _turns(makers, N, M, engine, form, device, n, reps)
        for f in ("a", "b", "a_hs", "b_hs", "hs_edge_a", "hs_edge_b"):
            if not torch.equal(getattr(states["this"], f),
                               getattr(states["parent"], f)):
                raise RuntimeError(f"{name}: {f} differs from the other "
                                   f"checkout's")
        out[name] = t
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1 or not os.path.isdir(os.path.join(argv[0],
                                                        "slb2d_tpu_torch")):
        print(f"ERROR: {USAGE}", file=sys.stderr)
        return 2
    if not have_card():
        return 1
    from ..bench import device_line
    card = device_line()
    res = compare(argv[0])
    for name, t in res.items():
        print(f"{name}: µs a step in turns, this "
              f"{'/'.join(f'{v:.3f}' for v in t['this'])}, other "
              f"{'/'.join(f'{v:.3f}' for v in t['parent'])}; this/other "
              f"{sum(t['this']) / sum(t['parent']):.4f}; states bit for "
              f"bit [{card}]", flush=True)
    print(json.dumps({"experiment": "vs parent", "device": card,
                      "steps": STEPS, "us_turns": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
