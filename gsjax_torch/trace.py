"""Spans and counters inside the port, recorded only while a torch.profiler
profile records.

    with trace.span("backward"):
        loss.backward()

    @trace.spanned("layout")    # each call a span
    def build_home_layout(...): ...

    trace.count("home_rows", nh)
    trace.host_sync(t)          # the host is about to wait for t's device

The switch is the profiler's own flag
(torch.autograd.profiler._is_profiler_enabled): with no profile
recording, span() is one flag check and a shared null context, and
count() and host_sync() return. While a profile records, a span keeps

  * its name, and a record_function range "gsjax_torch.<name>" on the
    profiler's timeline;
  * its host start and end, time.time_ns(), the clock of the profiler's
    events;
  * its parent's id and its root's id: the root is the outermost open
    span (one request's `render`, one step's `step`, one `resort`), and
    every span under it shares the root's id;
  * on a CUDA machine, the indices of two markers: at entry and at exit
    the tracer launches one MARK kernel (torch.cuda._sleep(0), a single
    thread that returns at once) on the current stream and numbers it.
    The k-th MARK of the profiler's device trace is marker k, so the
    device work between a span's two markers, which a reader of the trace
    takes as the busy time of every other device operation there, is the
    span's own (gsbench/program_trace.py). Nothing waits for them.

A counter keeps (root id, value) pairs; a value may be a 0-d device
tensor, read by snapshot().

The stack of open spans is the process's, not a thread's: autograd runs
a CUDA backward (_BlendStream.backward, _HomeGather.backward) on a
thread of its own while the caller waits in backward(), and their spans
belong under the caller's; the markers go to the stream autograd sets
there, the forward's. The records stay in memory until reset(), which
kernels.reset_launches() calls, so a run has one reset.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

from gsjax_torch import kernels

MARK = "spin_kernel"  # the marker kernel's name in a profiler trace
_NULL = contextlib.nullcontext()
_SPANS: list = []  # every Span since the last reset, in entry order
_OPEN: list = []  # the open Spans, innermost last
_COUNTS: dict = {}  # name -> [(root id, value)]
_IDS = itertools.count()
_MARKS = [0]  # markers launched since the last reset


def _mark() -> int:
    """Launch the next marker on the current stream; its index (-1 with no
    CUDA context, where nothing runs on a card)."""
    if not torch.cuda.is_initialized():
        return -1
    torch.cuda._sleep(0)
    _MARKS[0] += 1
    return _MARKS[0] - 1


class Span:
    """One span's record (see the module's docstring)."""

    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "m0", "m1")

    def __init__(self, name: str, parent, t0_ns: int, m0: int):
        self.name = name
        self.id = next(_IDS)
        self.parent = -1 if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.t0_ns = t0_ns
        self.t1_ns = 0
        self.m0 = m0
        self.m1 = -1


class _Recorder:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _profiler.record_function("gsjax_torch." + self.name)
        self.rf.__enter__()
        t0_ns = time.time_ns()
        self.rec = Span(self.name, _OPEN[-1] if _OPEN else None, t0_ns, _mark())
        _SPANS.append(self.rec)
        _OPEN.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.m1 = _mark()
        rec.t1_ns = time.time_ns()
        if _OPEN and _OPEN[-1] is rec:
            _OPEN.pop()
        self.rf.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a torch.profiler profile records now."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context that records the span `name` while a profile records (a
    shared null context otherwise)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Recorder(name)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Recorder(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, value=1) -> None:
    """Add `value` (a number or a 0-d tensor) to the counter `name`, under
    the open root, while a profile records."""
    if _profiler._is_profiler_enabled:
        _COUNTS.setdefault(name, []).append((_OPEN[0].root if _OPEN else -1, value))


def host_sync(t: torch.Tensor) -> None:
    """Count one `host_syncs` where the host is about to wait for the
    device of `t`: a CUDA tensor's read, or a copy to it from pageable
    host memory (nothing waits on the CPU)."""
    if _profiler._is_profiler_enabled and t.is_cuda:
        count("host_syncs")


def reset() -> None:
    """Forget every record."""
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()
    _MARKS[0] = 0


kernels.on_reset(reset)


def snapshot() -> dict:
    """The records since the last reset, for reading after the window:
    {"spans": [{"name", "id", "parent", "root", "t0_ns", "t1_ns", "m0",
    "m1"}], closed spans in entry order (parent -1 on a root; m0, m1 the
    markers at entry and exit, -1 without CUDA), "marks": the markers
    launched, "counts": {name: [(root, value)]}, each value a float}."""
    spans = [{"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
              "t0_ns": s.t0_ns, "t1_ns": s.t1_ns, "m0": s.m0, "m1": s.m1}
             for s in _SPANS if s.t1_ns]
    counts = {k: [(r, float(v)) for r, v in vals] for k, vals in _COUNTS.items()}
    return {"spans": spans, "marks": _MARKS[0], "counts": counts}
