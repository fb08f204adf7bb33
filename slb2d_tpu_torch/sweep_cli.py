"""Command-line parameter sweeps: `slb2d-torch-sweep` / `python -m
slb2d_tpu_torch.sweep_cli`.

The port of ``slb2d_tpu/sweep_cli.py`` on one device: a whole grid runs
as one batch (BASELINE config #5, absorption maps) on the stacked sweep
kernel (csrc/sweep_stack.cu, one launch per chunk; omega axes ride its
per-omega mode) or on the batched torch engine (parallel/sweep.py), as
parallel/sweep.choose_engine routes them.

Usage: the regular solver `key=value` arguments (display is ignored; sweeps
are display-4 semantics) plus any number of

    sweep:NAME=lo,hi,count        linspace grid over NAME
    sweep:NAME=v1;v2;v3           explicit values

Multiple sweep axes form the cartesian product.  Output: one line per
point with all six physics parameters and the display-4 observables, byte
for byte in the JAX package's format.

`frames-dir=DIR` additionally writes each point's final distribution
f(phi_x, phi_y), captured at that point's own loop exit, as
DIR/grid%02d/point%04d.data files in the display-7 triplet format, plus
an index.txt of point parameters, as the JAX CLI writes them.  Either
engine captures them; with omega swept the kernel copies each point's
arrays at its own exit.

Interactive refinement (`read-from=stdin`, the sweep analogue of the
reference's parameter server, src/boltzmann_cli.c:71-91): after each
grid's results are written, one line of new `sweep:` specs (optionally
with `key=value` scalar overrides) is read from stdin and run as the next
grid (its frames go to the next grid%02d).  `exit` or EOF quits.

`profile-dir=DIR` runs each grid under torch.profiler and writes its
Chrome trace under DIR (slb2d-torch's profile-dir=).

The run uses CUDA device `device=` (default 0) for every impl; only
device=cpu runs it on the CPU.  Not ported yet (NotImplementedError):
`shards>1` (ROADMAP.md queue A item 9).
"""

from __future__ import annotations

import sys

import numpy as np


def parse_sweep_args(argv):
    sweeps = {}
    rest = []
    for tok in argv:
        if tok.startswith("sweep:"):
            body = tok[len("sweep:"):]
            name, _, spec = body.partition("=")
            # any malformed spec — wrong token count OR unparseable
            # number — takes the same clean error path (the interactive
            # refinement loop catches the SystemExit and re-reads)
            try:
                if ";" in spec:
                    vals = np.asarray([float(v) for v in spec.split(";")])
                else:
                    parts = spec.split(",")
                    if len(parts) != 3:
                        raise ValueError("want lo,hi,count or v1;v2;...")
                    lo, hi = float(parts[0]), float(parts[1])
                    vals = np.linspace(lo, hi, int(parts[2]))
            except ValueError:
                print(f"ERROR: bad sweep spec {tok!r} "
                      "(want lo,hi,count or v1;v2;...)", file=sys.stderr)
                raise SystemExit(1)
            sweeps[name] = vals
        else:
            rest.append(tok)
    return sweeps, rest


HEADER = ("#E_dc E_omega omega mu alpha B "
          "v_dr_av v_y_av m_over_m_x_av A Asin "
          "v_dr_inst v_y_inst m_over_m_x_inst norm\n")


def _point_params(cfg, params, i):
    """The six physics parameters of point i (swept value or cfg scalar),
    in SWEEPABLE order."""
    from .parallel.sweep import SWEEPABLE
    return [(k, float(params[k][i]) if k in params else
             float(getattr(cfg, k))) for k in SWEEPABLE]


def _write_point_frames(cfg, sweep, res, frames_dir, grid_no):
    """Per-point final-distribution frames (`frames-dir=`): each sweep
    point's f(phi_x, phi_y) at its own loop exit, reconstructed from the
    captured (a, b) arrays in the display-7 triplet format
    (reference print_2d_data, src/boltzmann_c_solver.c:334-353), one file
    per point plus an index.txt mapping points to parameter values.
    Refinement grids go to separate grid%02d subdirectories."""
    import os

    from .io import writers
    from .ops.frames import FrameReconstructor
    from .parallel.sweep import SWEEPABLE

    a, b = sweep.final_ab
    d = os.path.join(frames_dir, f"grid{grid_no:02d}")
    os.makedirs(d, exist_ok=True)
    m = sweep.base
    recon = FrameReconstructor(m)        # tables are parameter-independent
    m_lo, m_hi = 1, m.M + 2              # display-7 frame bounds
    with open(os.path.join(d, "index.txt"), "w") as idx:
        idx.write("#point " + " ".join(SWEEPABLE) + "\n")
        for i in range(sweep.B):
            kv = _point_params(cfg, sweep.params, i)
            idx.write(f"{i:04d} "
                      + " ".join(f"{v:.12e}" for _, v in kv) + "\n")
            with open(os.path.join(d, f"point{i:04d}.data"), "w") as fh:
                fh.write("# " + " ".join(
                    f"{k}={v:.12e}" for k, v in kv) + "\n")
                F = recon.reconstruct(a[i], b[i], m_lo, m_hi)
                writers._write_xy_rows(fh, recon.phi_x, m.phi[m_lo:m_hi], F)
                fh.write(f"# norm={writers.f20(res['norm'][i])}\n")


def _run_one_grid(cfg, sweeps, out, device, frames_dir=None, grid_no=0):
    """Build, run, and write one sweep grid; returns the point count."""
    from .cli import profiled
    from .parallel.sweep import ParameterSweep

    grids = np.meshgrid(*sweeps.values(), indexing="ij")
    flat = {k: g.ravel() for k, g in zip(sweeps.keys(), grids)}
    B = len(next(iter(flat.values())))

    sweep = ParameterSweep(cfg, flat, device=device,
                           capture_state=frames_dir is not None)
    if not cfg.quiet:
        print(f"# sweeping {list(sweeps.keys())} over {B} points "
              f"({sweep.n_steps} steps each) on {sweep.device} "
              f"[{sweep.engine} engine]", file=sys.stderr)
    # checkpoint= saves the batch state every steps-per-chunk steps (and
    # at the end); resume= continues an interrupted sweep of the same grid
    # profile-dir=DIR: each grid's run under torch.profiler, one trace each
    with profiled(cfg.profile_dir, sweep.device):
        res = sweep.run(checkpoint=cfg.checkpoint, resume=cfg.resume,
                        checkpoint_every=cfg.steps_per_chunk)
    out.write(HEADER)
    for i in range(B):
        vals = [v for _, v in _point_params(cfg, sweep.params, i)]
        obs = [res[k][i] for k in (
            "v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin",
            "v_dr_inst", "v_y_inst", "m_over_m_x_inst", "norm")]
        out.write(" ".join(f"{float(v):.12e}" for v in vals + obs) + "\n")
    out.flush()
    # after the table: a failing frames write must not cost the results
    if frames_dir is not None:
        _write_point_frames(cfg, sweep, res, frames_dir, grid_no)
    return B


# scalar keys a refinement line may override: the six REPL-mutable physics
# parameters plus the run length and step.  Deliberately NOT dtype /
# g-grid / n-harmonics / shards / o: those change array shapes or the
# output stream mid-session.
REFINE_KEYS = ("E_dc", "E_omega", "omega", "mu", "alpha", "B",
               "t-max", "dt")


def _read_refinement(cfg, stream):
    """Read one refinement line from the interactive stream.

    A line is tokens in argv syntax: `sweep:NAME=...` specs plus optional
    scalar `key=value` overrides from REFINE_KEYS.  A line that fails any
    check (no sweep axes, unknown/invalid override, config validation) is
    rejected WHOLE — nothing from it is applied — and the next line is
    read.  Returns (cfg, sweeps) or None on exit/EOF."""
    from . import config as cfgmod

    while True:
        line = stream.readline()
        if line == "":
            return None                     # EOF behaves like exit
        toks = line.split()
        if not toks:
            continue                        # blank line: keep reading
        if toks[0] == "exit":
            return None
        try:
            sweeps, rest = parse_sweep_args(toks)
        except SystemExit:
            continue                        # bad spec: report and re-read
        if not sweeps:
            print("# rejected line: no sweep: axes (need at least one, "
                  "or `exit`)", file=sys.stderr)
            continue
        overrides = {}
        bad = False
        for tok in rest:
            name, _, value = tok.partition("=")
            if name not in REFINE_KEYS or not value:
                print(f"# rejected line: {tok!r} is not an overridable "
                      f"key=value (allowed: {', '.join(REFINE_KEYS)})",
                      file=sys.stderr)
                bad = True
                break
            field, conv = cfgmod._KEYMAP[name]
            try:
                overrides[field] = conv(value)
            except ValueError:
                print(f"# rejected line: bad value in {tok!r}",
                      file=sys.stderr)
                bad = True
                break
        if bad:
            continue
        new_cfg = cfg.replace(**overrides) if overrides else cfg
        try:
            cfgmod.validate(new_cfg)
        except cfgmod.ConfigError:          # message already printed
            print("# rejected line: invalid configuration",
                  file=sys.stderr)
            continue
        return new_cfg, sweeps


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # frames-dir=DIR: per-point final-distribution frames for every grid
    # of the session (a sweep-only key, extracted before config parsing)
    frames_dir = None
    for tok in list(argv):
        if tok.startswith("frames-dir="):
            frames_dir = tok[len("frames-dir="):] or None
            argv.remove(tok)
    if frames_dir is not None:
        import os
        try:
            # fail BEFORE the sweep runs, not after hours of compute
            os.makedirs(frames_dir, exist_ok=True)
        except OSError as e:
            print(f"ERROR: cannot create frames-dir={frames_dir!r}: {e}",
                  file=sys.stderr)
            return 1
    try:
        sweeps, rest = parse_sweep_args(argv)
    except SystemExit:           # malformed spec: message already printed
        return 1
    if not sweeps:
        print("ERROR: no sweep: axes given.", file=sys.stderr)
        return 1
    if not any(t.startswith("display=") for t in rest):
        rest = ["display=4"] + rest

    from . import config as cfgmod
    try:
        cfg = cfgmod.parse_cmd(rest)
    except cfgmod.ConfigError:
        return 1
    try:
        device = cfgmod.torch_device(cfg)
    except RuntimeError as e:       # no card, or no such card
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    out = cfgmod.open_out(cfg)
    try:
        try:
            _run_one_grid(cfg, sweeps, out, device, frames_dir, 0)
        except ValueError as e:   # e.g. an unsweepable axis
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        # refinement grids are new grids: never resume them from the
        # first grid's checkpoint (checkpoint= keeps saving, last grid
        # wins)
        cfg = cfg.replace(resume=None)
        # interactive refinement loop (read-from=stdin)
        grid_no = 0
        while cfg.read_from == "stdin":
            nxt = _read_refinement(cfg, sys.stdin)
            if nxt is None:
                break
            cfg, sweeps = nxt
            try:
                # grid numbering stays dense: a rejected grid must not
                # consume a frames grid%02d slot
                _run_one_grid(cfg, sweeps, out, device, frames_dir,
                              grid_no + 1)
                grid_no += 1
            except ValueError as e:          # e.g. unsweepable axis name
                print(f"ERROR: {e}", file=sys.stderr)
    finally:
        if out is not sys.stdout and out is not sys.stderr:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
