"""Spans and counters of slb2d_tpu_torch: the program's one recorder.

A span names a stretch of host time at a layer boundary of the single-run
and sweep paths (config.parse, sim.init, model.build, schedule.chunk,
engine.chunk, engine.fetch, io.write, ...; PERF.md §3 lists them with the
metrics that read them).  Each records (name, start, end, id, parent,
run, thread):

  start, end  time.time_ns(), the clock torch.profiler stamps its events
              with, so that spans and the device's kernels share one
              timeline
  parent      the id of the enclosing span on the same thread
  run         the id shared by every span of one Simulation or one
              ParameterSweep (run_id()); a span without one takes its
              parent's

Spans are recorded while torch.profiler records (each then also opens a
record_function range of its name, so the profiler's timeline shows them
over the kernels: profile-dir= and the benchmark's --trace 1) and inside
recording(), for tools that want spans without the profiler.  Otherwise
span() returns one shared object that does nothing: one flag check, no
allocation, no profiler call.  Recorded spans stay in memory until
reset(); the profiler's trace is their export.  The range is torch's C++
record function in function scope (_RecordFunctionFast): ~0.4 us against
~9 us for the Python record_function, the span's stamps inside it and
within a us or so of its own, and, unlike record_function's user scope,
no copy of it among the device's events, where a reader of device
activity would take it for work.

Counters are always on: count(name, n) adds to a name such as
launches.<kernel>.<form> (the kernels' launches) or engine.chunks.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

# the profiler range a span opens: (name) -> a context manager
_Range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    run: int | None
    thread: int


_spans: list = []
_counters: dict = {}
_lock = threading.Lock()
_span_ids = itertools.count(1)
_run_ids = itertools.count(1)
_local = threading.local()
_recording = 0


class _Untraced:
    """The span of a stretch while nothing records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_UNTRACED = _Untraced()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded: its stamps fall inside its profiler range,
    next to the profiler's own (the range's set-up, which sometimes grows
    the profiler's buffers, stays outside them)."""
    __slots__ = ("name", "run", "id", "parent", "start", "range", "stack")

    def __init__(self, name, run):
        self.name, self.run = name, run

    def __enter__(self):
        self.stack = _stack()
        top = self.stack[-1] if self.stack else None
        self.parent = None if top is None else top.id
        if self.run is None and top is not None:
            self.run = top.run
        self.id = next(_span_ids)
        self.stack.append(self)
        self.range = (_Range(self.name) if _profiler._is_profiler_enabled
                      else None)
        if self.range is not None:
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.run, threading.get_ident()))
        return False


def span(name: str, run: int | None = None):
    """A context manager around one stretch of host time named `name`;
    run: its run id (default: the enclosing span's)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _UNTRACED
    return _Open(name, run)


def traced(name: str):
    """A decorator: every call of the function is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_recording or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Open(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def spanned(name: str, iterable):
    """The items of iterable, each next() a span named `name` (the last,
    which ends the iteration, too)."""
    it = iter(iterable)
    end = object()
    while True:
        with span(name):
            item = next(it, end)
        if item is end:
            return
        yield item


def run_id() -> int:
    """The run of the innermost open span on this thread that has one, or
    a new id: a Simulation or ParameterSweep takes one when it is built,
    and one built inside another's span joins its run."""
    for s in reversed(getattr(_local, "stack", ())):
        if s.run is not None:
            return s.run
    return next(_run_ids)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without the profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def count(name: str, n: int = 1):
    """Add n to the counter `name`.  No lock: a counter is counted from one
    thread at a time."""
    _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The recorded spans, in the order they ended."""
    return list(_spans)


def counters() -> dict:
    """Every counter by name."""
    return dict(_counters)


def counted(prefix: str) -> int:
    """The sum of the counter `prefix` and of every counter under it
    (prefix + "." ...): counted("launches.B3.omega") is the per-omega B3
    launches of either form."""
    return sum(v for k, v in dict(_counters).items()
               if k == prefix or k.startswith(prefix + "."))


def reset():
    """Forget every span and counter."""
    _spans.clear()
    _counters.clear()
