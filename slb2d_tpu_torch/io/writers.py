"""Output writers for display modes 3/4/7/8/9/77.

Byte-format-compatible with the reference (`%0.5f`/`%0.20f` columns, `#`
headers, frame%08d.data naming) so downstream plotting scripts keep
working.  Numerical deviations from reference DEFECTS are documented in
docs/DEVIATIONS.md: loops that read past the live array region in the
reference (print_time_evolution_of_parameters, print_2d_data norms,
src/boltzmann_c_solver.c:306,336; src/boltzmann_solver.c:405,420,490) use
the in-bounds m ranges here, and the display-77 normalization does not
mutate the running averages (the C path compounds multipliers in place,
:319-325).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import tracing
from ..constants import PI
from ..ops import observables
from . import native

f64 = np.float64

# Column headers, verbatim from the reference printf strings
HEADER_D4 = ("#E_{dc}                \\tilde{E}_{\\omega}     \\tilde{\\omega}"
             "         mu                     v_{dr}/v_{p}         A(\\omega)"
             "              NORM     v_{y}/v_{p}    m/m_{x,k}   <v_{dr}/v_{p}>"
             "   <v_{y}/v_{p}>    <m/m_{x,k}>    Asin\n")
HEADER_D77 = ("#E_{dc}                \\tilde{E}_{\\omega}     \\tilde{\\omega}"
              "         mu                     v_{dr}/v_{p}         A(\\omega)"
              "              NORM     v_{y}/v_{p}    m/m_{x,k}   <v_{dr}/v_{p}>"
              "   <v_{y}/v_{p}>    <m/m_{x,k}>  A_{inst}  t    Asin\n")


def f20(x) -> str:
    return f"{float(f64(x)):.20f}"


def f5(x) -> str:
    return f"{float(f64(x)):.5f}"


def _echo(msg: str, out):
    """The reference printf()s norms to stdout in addition to `out`."""
    if out is not sys.stdout:
        sys.stdout.write(msg)
        sys.stdout.flush()


def write_display4(out, model, cfg, a, b, av_data, *, quiet=False,
                   t_start=None):
    """Final observable line (src/boltzmann_c_solver.c:236-268).

    t_start: the LIVE averaging start (REPL mutations move it, reference
    :275, and the header prints the moved value); defaults to cfg's."""
    norm = observables.eval_norm(model, a)
    obs = observables.scaled_observables(model, a, b, av_data, bounds="d4",
                                         quadrature_denom=model.T)
    if not quiet:
        print(f"\n# norm={f20(norm)}")
    out.write(
        "# display=%d E_dc=%s E_omega=%s omega=%s mu=%s alpha=%s "
        "n-harmonics=%d PhiYmin=%s PhiYmax=%s B=%s t-max=%s dt=%s g-grid=%d\n"
        % (cfg.display, f20(model.E_dc), f20(model.E_omega), f20(model.omega),
           f20(model.mu), f20(model.alpha), model.N, f20(model.phi_y_min),
           f20(model.phi_y_max), f20(model.B),
           f20(model.np_dtype(cfg.t_start if t_start is None else t_start)),
           f20(model.dt), model.M))
    out.write(HEADER_D4)
    d = obs["av"]
    out.write(" ".join([
        f20(model.E_dc), f20(model.E_omega), f20(model.omega), f20(model.mu),
        f20(obs["v_dr_inst"]), f20(d[4]), f20(norm), f20(obs["v_y_inst"]),
        f20(obs["m_over_m_x_inst"]), f20(d[1]), f20(d[2]), f20(d[3]),
        f20(d[5])]) + "\n")
    out.flush()
    return norm


def write_display77_line(out, model, a_prev, b_prev, av_data, t, *,
                         quiet=False):
    """Time-evolution line (GPU semantics, src/boltzmann_solver.c:412-445):
    arrays are the PRE-step state; averages the post-step av_data; the
    quadratures normalize by t."""
    norm = observables.eval_norm(model, a_prev)
    obs = observables.scaled_observables(model, a_prev, b_prev, av_data,
                                         bounds="av", quadrature_denom=t)
    if not quiet:
        print(f"\n# t={f20(t)} norm={f20(norm)}")
    d = obs["av"]
    # A_inst = cos(omega*t)*v_dr_inst evaluated in double (:444)
    a_inst = float(np.cos(f64(model.np_dtype(model.omega * model.np_dtype(t))))
                   ) * float(obs["v_dr_inst"])
    out.write(HEADER_D77)
    out.write(" ".join([
        f20(model.E_dc), f20(model.E_omega), f20(model.omega), f20(model.mu),
        f20(obs["v_dr_inst"]), f20(d[4]), f20(norm), f20(obs["v_y_inst"]),
        f20(obs["m_over_m_x_inst"]), f20(d[1]), f20(d[2]), f20(d[3]),
        f20(a_inst), f20(model.np_dtype(t)), f20(d[4])]) + "\n")
    out.flush()
    return norm


def write_display77_from_record(out, model, records, *, quiet=False):
    """Format a chunk's on-device emission records
    (ops/stencil.emission_record: [norm_sum, v_dr_sum, v_y_sum, m_x_sum,
    t, av[0..5]], an (R, >= 11) stack) as display-77 lines in one pass:
    the columns of all R lines at once, rounded where the per-record
    reference rounds (_d77_columns), then the text by io/d77fmt.cpp's
    slb_format_d77_rows or, without the library, Python's %-operator, the
    same bytes either way; one write and one flush of `out`.  Unless
    `quiet`, each record's "# t= norm=" line goes to stdout before it, in
    the same stream where `out` is stdout.  Counts io.records and
    io.records_native (those the native formatter wrote) while spans
    record.  Returns the R norms."""
    cols = _d77_columns(model, records)
    if quiet or out is sys.stdout:
        text, native_ = _d77_text(cols, echo=not quiet, lines=True)
    else:
        echo, _ = _d77_text(cols, echo=True, lines=False)
        sys.stdout.write(echo)
        text, native_ = _d77_text(cols, echo=False, lines=True)
    out.write(text)
    out.flush()
    if tracing.active():
        tracing.count("io.records", len(cols))
        if native_:
            tracing.count("io.records_native", len(cols))
    return cols[:, 6].astype(model.np_dtype)


# the echo of a record to stdout and its line's 15 columns
_D77_ECHO = "\n# t=%.20f norm=%.20f\n"
_D77_ROW = " ".join(["%.20f"] * 15) + "\n"


def _d77_columns(model, records):
    """(R, 15) float64: the columns of the display-77 lines of `records`
    (R, >= 11), each rounded in the model's np_dtype at the points where
    the per-record writer of the reference rounds it (f32 or f64)."""
    D = model.np_dtype
    r = np.asarray(records)[:, :11].astype(D)
    norm_sum, v_dr, v_y, m_x, t = r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4]
    d = r[:, 5:11]
    vm, ym, mm = (model.v_dr_multiplier, model.v_y_multiplier,
                  model.m_over_multiplier)
    with np.errstate(all="ignore"):      # a diverged run's nan and inf
        norm = (norm_sum.astype(f64)
                * (2 * PI * np.sqrt(f64(model.alpha)))).astype(D)
        d1, d2, d3 = d[:, 1] * vm, d[:, 2] * ym, d[:, 3] * mm
        d4 = (d[:, 4] * vm) / t
        v_dr_i = v_dr * vm
        # A_inst = cos(omega*t)*v_dr_inst evaluated in double (:444)
        a_inst = np.cos((model.omega * t).astype(f64)) * v_dr_i.astype(f64)
        cols = np.empty((len(r), 15), f64)
        cols[:, :4] = [f64(model.E_dc), f64(model.E_omega), f64(model.omega),
                       f64(model.mu)]
        for k, c in enumerate((v_dr_i, d4, norm, v_y * ym, m_x * mm, d1, d2,
                               d3, a_inst, t, d4), start=4):
            cols[:, k] = c
    return cols


def _d77_text(cols, *, echo, lines):
    """(text, whether the native formatter wrote it) of the records'
    columns: with `echo` each record's stdout line, with `lines` its
    header and line."""
    text = native.format_d77_rows(cols, HEADER_D77, echo=echo, lines=lines)
    if text is not None:
        return text, True
    fmt = (_D77_ECHO if echo else "") + (HEADER_D77 + _D77_ROW if lines
                                         else "")
    args = np.concatenate(([cols[:, [13, 6]]] if echo else [])
                          + ([cols] if lines else []), axis=1)
    return (fmt * len(cols)) % tuple(args.ravel().tolist()), False


def write_display3(out, model, recon, a, b):
    """Current vs equilibrium distribution dump
    (src/boltzmann_c_solver.c:219-234): m runs 1..M-1."""
    m_lo, m_hi = 1, model.M           # exclusive hi: m < M
    F = recon.reconstruct(a, b, m_lo, m_hi)
    F0 = recon.reconstruct_equilibrium(m_lo, m_hi)
    phi = model.phi
    lines = []
    for i, px in enumerate(recon.phi_x):
        spx = f5(px)
        row = F[i]
        row0 = F0[i]
        for j in range(m_hi - m_lo):
            lines.append("%s %s %s %s\n" % (
                spx, f5(phi[m_lo + j]), f20(row[j]), f20(row0[j])))
    out.write("".join(lines))
    norm = observables.eval_norm(model, a)
    out.write(f"# norm={f20(norm)}\n")
    _echo(f"# norm={f20(norm)}\n", out)
    return norm


def write_frame(out, model, recon, a, b, t, *, with_t_header=True,
                F=None, norm=None):
    """2-D frame (GPU print_2d_data format, src/boltzmann_solver.c:487-507):
    m runs 1..M+1; `# t=` header; norm over the in-bounds m=1..M.

    F/norm may be precomputed (device-side reconstruction path); otherwise
    they are derived from the host arrays a, b."""
    if with_t_header:
        out.write(f"# t={f20(model.np_dtype(t))}\n")
    m_lo, m_hi = 1, model.M + 2       # m < M+2
    if F is None:
        F = recon.reconstruct(a, b, m_lo, m_hi)
    phi = model.phi
    _write_xy_rows(out, recon.phi_x, phi[m_lo:m_hi], F)
    if norm is None:
        norm = observables.eval_norm(model, a)
    out.write(f"# norm={f20(norm)}\n")
    _echo(f"# norm={f20(norm)}\n", out)
    return norm


def write_strobe(out, model, recon, strobe_values, a, t, *, norm=None):
    """Strobe frame (display 9, src/boltzmann_solver.c:459-484):
    accumulated f over drive periods; footers `# norm=` then `# t=`."""
    m_lo, m_hi = 1, model.M + 2
    phi = model.phi
    _write_xy_rows(out, recon.phi_x, phi[m_lo:m_hi], strobe_values)
    if norm is None:
        norm = observables.eval_norm(model, a)
    out.write(f"# norm={f20(norm)}\n")
    out.write(f"# t={f20(model.np_dtype(t))}\n")
    _echo(f"# norm={f20(norm)}\n", out)
    return norm


def _write_xy_rows(out, phi_x, phi_y, F):
    if native.write_xy_rows_native(out, phi_x, phi_y, F):
        return
    lines = []
    for i, px in enumerate(phi_x):
        spx = f5(px)
        row = F[i]
        for j in range(len(phi_y)):
            lines.append("%s %s %s\n" % (spx, f5(phi_y[j]), f20(row[j])))
    out.write("".join(lines))
