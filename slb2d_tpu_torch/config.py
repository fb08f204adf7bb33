"""Simulation configuration and CLI front end.

Maps 1:1 onto the reference's ``key=value`` command-line surface
(reference: src/boltzmann_cli.c:93-189) plus the stdin parameter-server
protocol (src/boltzmann_cli.c:71-91).  Extensions (impl, dtype,
steps-per-chunk, ...) are additive and default to reference behavior.

The parsing rules and messages are those of ``slb2d_tpu.config``; the
engines differ: ``impl=torch`` is the plain tensor path, ``impl=stream``
the temporal-tiling CUDA kernel (B2; its plain version with device=cpu,
as the JAX package's impl=stream runs interpreted on the CPU), and
``impl=cuda`` (``auto`` means ``cuda``) the step kernel (B1) or B2,
whichever ran a step faster on an H100 at the grid's shape.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import IO, Optional, Union

from . import tracing

VALID_DISPLAYS = (3, 4, 7, 8, 9, 77)

# Parameters the interactive parameter server may mutate, one at a time
# (reference: src/boltzmann_cli.c:82-87).
REPL_MUTABLE = ("E_dc", "E_omega", "omega", "mu", "alpha", "B")

IMPLS = ("auto", "torch", "cuda", "stream")

# engines of the JAX package and their counterparts here
_JAX_IMPLS = {"xla": "torch", "pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen snapshot of all solver parameters.

    Field-for-field image of the reference globals (src/boltzmann_cli.c:20-68,
    src/boltzmann_c_solver.c:36-59).
    """

    display: int
    E_dc: float
    E_omega: float
    omega: float
    mu: float
    alpha: float
    n_harmonics: int          # N; CLI key "n-harmonics"
    phi_y_min: float          # CLI "PhiYmin"
    phi_y_max: float          # CLI "PhiYmax"
    B: float
    t_start: float            # CLI "t-max"; run extends to t_start + T
    frame_start: float = 0.0
    dt: float = 0.001
    g_grid: int = 3069        # M; CLI "g-grid"
    quiet: bool = False
    device: Union[int, str] = 0   # CUDA device ordinal, or "cpu"
    out_file: str = "-"       # CLI "o"; "-"/"stdout", "stderr", "+file" appends
    read_from: Optional[str] = None   # only "stdin" supported, like reference

    # ---- extensions (not present in the reference CLI) ----
    impl: str = "auto"        # {"auto", "torch", "cuda", "stream"} stepper
                              # implementation; auto means cuda
    dtype: str = "f32"        # {"f32", "f64"}; reference is float32 (src/boltzmann.h:15)
    exact_time: bool = True   # replicate the C solver's float32 `t += dt` accumulation
    steps_per_chunk: int = 0  # 0 = auto; max steps between host syncs
    checkpoint: Optional[str] = None   # save final state to .npz
    resume: Optional[str] = None       # load initial state from .npz
    shards: int = 1          # spatial shards of the phi_y axis
    frame_batch: int = 8     # frame/strobe emissions accumulated on the
                             # device per host transfer (displays 7 and
                             # 9; 1 = write per emission)
    warmup: bool = False     # build every step runner before the timed run
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace output

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @property
    def N(self) -> int:
        return self.n_harmonics

    @property
    def M(self) -> int:
        return self.g_grid


# CLI key -> (field name, converter).  Converters mirror the reference:
# atoi for ints, strtod for floats (src/boltzmann_cli.c:105-122).
_KEYMAP = {
    "display": ("display", int),
    "E_dc": ("E_dc", float),
    "E_omega": ("E_omega", float),
    "omega": ("omega", float),
    "mu": ("mu", float),
    "alpha": ("alpha", float),
    "n-harmonics": ("n_harmonics", lambda v: int(float(v))),
    "PhiYmin": ("phi_y_min", float),
    "PhiYmax": ("phi_y_max", float),
    "B": ("B", float),
    "t-max": ("t_start", float),
    "frame-start": ("frame_start", float),
    "dt": ("dt", float),
    "g-grid": ("g_grid", int),
    "read-from": ("read_from", str),
    "quiet": ("quiet", lambda v: True),
    "device": ("device", lambda v: v if v == "cpu" else int(v)),
    "o": ("out_file", str),
    # extensions
    "impl": ("impl", str),
    "dtype": ("dtype", str),
    "exact-time": ("exact_time", lambda v: v not in ("0", "false", "no")),
    "steps-per-chunk": ("steps_per_chunk", int),
    "checkpoint": ("checkpoint", str),
    "resume": ("resume", str),
    "shards": ("shards", int),
    "frame-batch": ("frame_batch", int),
    "warmup": ("warmup", lambda v: v not in ("0", "false", "no")),
    "profile-dir": ("profile_dir", str),
}

_REQUIRED = (
    ("display", "display"),
    ("E_dc", "E_dc"),
    ("E_omega", "E_omega"),
    ("omega", "omega"),
    ("mu", "mu"),
    ("alpha", "alpha"),
    ("n_harmonics", "n-harmonics"),
    ("phi_y_min", "PhiYmin"),
    ("phi_y_max", "PhiYmax"),
    ("B", "B"),
    ("t_start", "t-max"),
)


class ConfigError(SystemExit):
    pass


def _die(msg: str):
    print(msg, file=sys.stderr)
    raise ConfigError(1)


@tracing.traced("config.parse")
def parse_cmd(argv: list[str]) -> SimConfig:
    """Parse ``key=value`` arguments exactly like the reference parser.

    Reference quirks preserved (src/boltzmann_cli.c:98-103): parsing stops
    at the first token that does not contain ``=``; unknown keys are
    silently ignored; later keys override earlier ones.
    """
    fields: dict = {}
    for tok in argv:
        if "=" not in tok:
            break
        name, _, value = tok.partition("=")
        if name == "" or value == "":
            break
        if name in _KEYMAP:
            field, conv = _KEYMAP[name]
            try:
                fields[field] = conv(value)
            except ValueError:
                _die(f'ERROR: Invalid value "{value}" for parameter "{name}".')

    for field, cli_name in _REQUIRED:
        if field not in fields:
            _die(f'ERROR: Parameter "{cli_name}" must be set.')

    cfg = SimConfig(**fields)
    validate(cfg)
    return cfg


def validate(cfg: SimConfig):
    if cfg.display not in VALID_DISPLAYS:
        _die("ERROR: Invalid value of display= parameter. "
             "Possible values are 3, 4, 8 or 77.")
    if cfg.t_start <= 0:
        _die("ERROR: Invalid value of t-max= parameter. "
             "it must be greater than 0.")
    if cfg.read_from is not None and cfg.read_from != "stdin":
        _die("ERROR: Invalid value of read-from=")
    if cfg.impl in _JAX_IMPLS:
        _die(f"ERROR: impl={cfg.impl} names an engine of the JAX package; "
             f"use impl={_JAX_IMPLS[cfg.impl]}, its counterpart here.")
    if cfg.impl not in IMPLS:
        _die("ERROR: impl= must be one of auto, torch, cuda, stream.")
    if cfg.dtype not in ("f32", "f64"):
        _die("ERROR: dtype= must be f32 or f64.")
    if cfg.g_grid < 3:
        _die("ERROR: g-grid too small.")
    if cfg.n_harmonics < 1:
        _die("ERROR: n-harmonics must be >= 1.")
    if cfg.shards < 1:
        _die("ERROR: shards= must be >= 1.")


def open_out(cfg: SimConfig) -> IO[str]:
    """Resolve the output stream (reference: src/boltzmann_cli.c:168-183)."""
    if cfg.out_file in ("-", "stdout"):
        return sys.stdout
    if cfg.out_file == "stderr":
        return sys.stderr
    if cfg.out_file.startswith("+"):
        return open(cfg.out_file[1:], "a")
    return open(cfg.out_file, "w")


def torch_device(cfg: SimConfig, device=None):
    """The torch.device a run uses: `device` when the caller gives one,
    else cuda:<cfg.device>, or the CPU for device=cpu, whatever the impl.
    A CUDA device that torch cannot see raises RuntimeError (the entry
    points print it and return 1): nothing falls back to the CPU."""
    import torch
    if device is None:
        device = "cpu" if cfg.device == "cpu" else f"cuda:{cfg.device}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: no CUDA device is available "
                               f"(device=cpu runs on the CPU)")
        if not 0 <= (device.index or 0) < torch.cuda.device_count():
            # the reference aborts when cudaSetDevice fails
            # (src/boltzmann_solver.c:77 via HANDLE_ERROR :14)
            raise RuntimeError(
                f"{device}: invalid device ordinal "
                f"({torch.cuda.device_count()} CUDA device(s))")
    return device


# fscanf treats input as one token stream, so "E_dc 1.5 0.5 exit" on a
# single line must leave "exit" for the next scan.  Leftovers are stored
# on the stream object itself (falling back to a keyed dict for exotic
# streams that reject attributes).
_repl_leftovers_fallback: dict = {}
_LEFTOVER_ATTR = "_slb2d_repl_leftovers"


def _get_leftovers(stream) -> list:
    toks = getattr(stream, _LEFTOVER_ATTR, None)
    if toks is None:
        toks = _repl_leftovers_fallback.pop(id(stream), [])
    return list(toks)


def _set_leftovers(stream, toks: list):
    try:
        setattr(stream, _LEFTOVER_ATTR, list(toks))
    except AttributeError:
        _repl_leftovers_fallback[id(stream)] = list(toks)


# longest C-float prefix (fscanf %f / strtof class: decimal with optional
# exponent, inf/infinity, nan).  Out-of-scope corners: hex floats and the
# fscanf all-or-nothing behavior on dangling exponents ("1e+"), which the
# reference parser would reject after consuming the prefix.
_FLOAT_PREFIX_RE = re.compile(
    r"[+-]?(?:(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)",
    re.IGNORECASE)


def scan_for_new_parameters(stream: IO[str]):
    """Read one parameter mutation from the interactive parameter server.

    fscanf-faithful emulation of the reference scanner
    (src/boltzmann_cli.c:71-91, ``fscanf("%s %f %f")`` in a retry loop):

    * ``exit`` terminates ONLY when the following ``%f`` fails (pcount==1
      there) — ``exit 1.0 2.0`` parses as an unknown-name mutation and
      the run continues;
    * a failed ``%f`` consumes NOTHING: scanning resumes AT the failed
      token (the reference drops only the name token, not the triple);
    * a partially numeric token (``1.5x``) yields its numeric prefix and
      the remainder re-enters the stream as the next token;
    * unknown names parse fine and mutate nothing.

    Returns ``None`` on exit/EOF, else ``(name_or_None, value, timeout)``
    with name in REPL_MUTABLE.  Deviation (docs/DEVIATIONS.md D14): at
    EOF the reference fscanf loop spins forever; we treat EOF as exit.
    """
    toks = _get_leftovers(stream)

    def next_tok():
        while not toks:
            line = stream.readline()
            if line == "":
                return None
            toks.extend(line.split())
        return toks.pop(0)

    def read_float():
        """%f: value on success (pushing back any non-numeric remainder
        of the token), None on failure (pushing the whole token back)."""
        t = next_tok()
        if t is None:
            return None
        m = _FLOAT_PREFIX_RE.match(t)
        if m is None:
            toks.insert(0, t)
            return None
        if m.end() < len(t):
            toks.insert(0, t[m.end():])
        return float(m.group(0))

    while True:
        name = next_tok()
        if name is None:
            _set_leftovers(stream, [])
            return None                       # EOF (D14)
        value = read_float()
        if value is None:                     # pcount == 1
            if name == "exit":
                _set_leftovers(stream, toks)
                return None
            continue
        timeout = read_float()
        if timeout is None:                   # pcount == 2
            continue
        _set_leftovers(stream, toks)
        return (name if name in REPL_MUTABLE else None, value, timeout)
