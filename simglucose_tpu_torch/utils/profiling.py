"""Profiling and throughput instrumentation.

Counterpart of ``simglucose_tpu/utils/profiling.py:19-60``: a trace
context on ``torch.profiler`` (the card's kernels and copies, and the
host's calls when asked) that writes a Chrome trace, and the env-steps/s
meter of the benches and the trainer CLI.  Beyond the JAX package: the
program's own spans and counters, put on the trace's clock.

**Spans.** ``with span("name"):`` (or ``@span("name")`` on a function)
records the name, start and end on the host's ``time.perf_counter_ns``
clock, the enclosing open span, and a call id shared by every span under
one top-level span; ``count(name, n)`` adds to a counter of the innermost
open span.  Spans are on only while a ``torch.profiler`` session is
active in the process (``torch.autograd.profiler._is_profiler_enabled``,
the flag the profiler sets for such checks): otherwise ``span`` checks
that flag and returns a shared null context, with no allocation, no
``record_function`` and no CUDA call.  The record is in memory, capped
at :data:`MAX_SPANS` (later spans are counted in :func:`dropped`), read
by :func:`spans` and emptied by :func:`clear_spans`.  One thread.

**The shared clock.**  A trace's clock is not the host's: each top-level
span, on entry, issues one *anchor* between two reads of the span clock:
``cudaStreamQuery`` on a stream of its own where CUDA is initialized (the
program's paths make that call nowhere else; a CUDA-only trace records
it as one host event), else a ``record_function`` range named
``profiling.anchor`` (seen by sessions that record the host's
activity).  :func:`trace_offset_us` pairs the trace's k-th anchor event
with the k-th recorded anchor and returns the offset from the span clock
to the trace's.  :func:`device_trace` writes the spans into its Chrome
trace as a host track and tabulates them in ``spans.json``.

On the card kernels run asynchronously: when :meth:`Throughput.stop` is
called the work it should time may still be queued.  So a meter given a
CUDA device synchronizes it in :meth:`~Throughput.start` and
:meth:`~Throughput.stop`; it then measures the work done, not the
launches.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import statistics
import time
from typing import Iterable, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from simglucose_tpu_torch.core.device import check_device

MAX_SPANS = 200_000  # the record's cap: ~0.2 KB a span, ~40 MB full
ANCHOR = "profiling.anchor"  # the anchor's range where CUDA is not initialized
ANCHOR_EVENTS = ("cudaStreamQuery", ANCHOR)  # the trace's names of an anchor
# the Chrome trace's categories of the card's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    parent: int  # index in spans() of the enclosing span; -1 at the top level
    call: int  # shared by every span under one top-level span
    counts: dict  # the counters charged to this span


_record: list = []  # [name, start, end, parent, call, counts or None] a span
_open: list = []  # indices into _record of the open spans, innermost last
_anchors: list = []  # (ns before, ns after) of each top-level span's anchor
_dropped = 0
_calls = 0
_nulls: dict = {}  # the shared null context of each name


def _wrap(name: str, fn):
    """``fn`` under ``span(name)``, the flag checked at each call."""

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not _autograd_profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Live(name):
            return fn(*args, **kwargs)

    return spanned


class _Null:
    """What :func:`span` returns while spans are off: one per name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.name, fn)


_anchor_stream = None  # a stream of the anchors' own, which holds no work


def _anchor():
    """One anchor between two reads of the span clock: a query of an empty
    stream (short, and it never waits for the card's work), or without
    CUDA a ``record_function`` range."""
    global _anchor_stream
    if torch.cuda.is_initialized():
        if _anchor_stream is None:
            _anchor_stream = torch.cuda.Stream()
        t0 = time.perf_counter_ns()
        _anchor_stream.query()
    else:
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(ANCHOR):
            pass
    _anchors.append((t0, time.perf_counter_ns()))


class _Live(_Null):
    """A span being recorded."""

    __slots__ = ("index",)

    def __enter__(self):
        global _dropped, _calls
        if len(_record) >= MAX_SPANS:
            _dropped += 1
            self.index = -1
            return self
        t = time.perf_counter_ns()
        if _open:
            parent = _open[-1]
            call = _record[parent][4]
        else:
            parent, call = -1, _calls
            _calls += 1
            _anchor()  # inside the span: its cost is the span's
        self.index = len(_record)
        _record.append([self.name, t, 0, parent, call, None])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            _record[self.index][2] = time.perf_counter_ns()
            _open.pop()
        return False


def span(name: str):
    """A span named ``name``: a context manager, or a decorator that
    spans each call of the function.  Off (no profiler session), the
    shared null context of the name."""
    if not _autograd_profiler._is_profiler_enabled:
        null = _nulls.get(name)
        if null is None:
            null = _nulls[name] = _Null(name)
        return null
    return _Live(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    while spans are off or no span is open)."""
    if not _autograd_profiler._is_profiler_enabled or not _open:
        return
    rec = _record[_open[-1]]
    if rec[5] is None:
        rec[5] = {}
    rec[5][name] = rec[5].get(name, 0) + n


def spans() -> List[Span]:
    """The recorded spans in the order they opened."""
    return [Span(r[0], r[1], r[2], r[3], r[4], dict(r[5] or {})) for r in _record]


def anchors() -> List[tuple]:
    """Each top-level span's anchor: (ns before, ns after) on the span
    clock, in order."""
    return list(_anchors)


def dropped() -> int:
    """Spans not recorded since the record reached :data:`MAX_SPANS`."""
    return _dropped


def clear_spans() -> None:
    """Empty the record (call it outside every span)."""
    global _dropped, _calls
    _record.clear()
    _open.clear()
    _anchors.clear()
    _dropped = _calls = 0


def trace_offset_us(host_events: Iterable[tuple], anchor_list: Optional[list] = None):
    """``(offset, spread)`` in microseconds: a span-clock time ``t_ns`` is
    ``t_ns / 1000 + offset`` on the trace's clock.  ``host_events`` are the
    trace's host events as ``(name, start_us, end_us)``; those named in
    :data:`ANCHOR_EVENTS`, in order of start, are paired one to one with
    ``anchor_list`` (default :func:`anchors`).  Each pair bounds the offset
    (the event lies between the anchor's two clock reads); the offset is
    the median of the pairs' midpoints, the spread the most by which it
    leaves any pair's bounds.  None where the counts differ or are 0."""
    found = sorted((a, b) for name, a, b in host_events if name in ANCHOR_EVENTS)
    marks = _anchors if anchor_list is None else anchor_list
    if not marks or len(found) != len(marks):
        return None
    lo_hi = [(e1 - t1 * 1e-3, e0 - t0 * 1e-3) for (e0, e1), (t0, t1) in zip(found, marks)]
    offset = statistics.median(0.5 * (lo + hi) for lo, hi in lo_hi)
    spread = max(max(lo - offset, offset - hi, 0.0) for lo, hi in lo_hi)
    return offset, spread


class Busy:
    """The union of ``(start, end)`` intervals, for the time it covers
    between any two points (one sort, then a bisection a query)."""

    def __init__(self, intervals: Iterable[tuple]):
        self.starts, self.ends, self.before = [], [], [0.0]
        for a, b in sorted(intervals):
            if self.ends and a <= self.ends[-1]:
                if b > self.ends[-1]:
                    self.before[-1] += b - self.ends[-1]
                    self.ends[-1] = b
                continue
            self.starts.append(a)
            self.ends.append(b)
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)  # intervals starting at or before t
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def covered(self, lo: float, hi: float) -> float:
        return self._upto(hi) - self._upto(lo) if hi > lo else 0.0


def span_table(span_list: List[Span], busy: Optional[Busy] = None,
               offset_us: Optional[float] = None) -> dict:
    """Per span name: calls, total and self milliseconds (self: the span
    less the spans it holds), the counters, and with ``busy`` (the card's
    busy intervals on the trace's clock) and ``offset_us`` the card's idle
    milliseconds under the span (``idle_ms``) and while it was the
    innermost open span (``idle_self_ms``)."""
    idle = [None] * len(span_list)
    if busy is not None and offset_us is not None:
        idle = [(s.end_ns - s.start_ns) * 1e-3
                - busy.covered(s.start_ns * 1e-3 + offset_us, s.end_ns * 1e-3 + offset_us)
                for s in span_list]
    self_ns = [s.end_ns - s.start_ns for s in span_list]
    idle_self = list(idle)
    for i, s in enumerate(span_list):
        if s.parent >= 0:
            self_ns[s.parent] -= s.end_ns - s.start_ns
            if idle[i] is not None:
                idle_self[s.parent] -= idle[i]
    out = {}
    for i, s in enumerate(span_list):
        row = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0,
                                      "idle_ms": None, "idle_self_ms": None, "counts": {}})
        row["calls"] += 1
        row["total_ms"] += (s.end_ns - s.start_ns) * 1e-6
        row["self_ms"] += self_ns[i] * 1e-6
        if idle[i] is not None:
            row["idle_ms"] = (row["idle_ms"] or 0.0) + idle[i] * 1e-3
            row["idle_self_ms"] = (row["idle_self_ms"] or 0.0) + idle_self[i] * 1e-3
        for k, v in s.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return out


SPAN_TID = 0x5A  # the spans' track in the Chrome trace


def _write_spans(logdir: str, first: int, first_anchor: int) -> None:
    """Add the spans recorded since index ``first`` to ``trace.json`` as a
    host track on the trace's clock, and write ``spans.json``."""
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    got = [s._replace(parent=s.parent - first if s.parent >= first else -1)
           for s in spans()[first:]]
    timed = [e for e in events if e.get("ph") == "X"]
    clock = trace_offset_us(((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                             for e in timed), _anchors[first_anchor:])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in timed
           if e.get("cat") in DEVICE_CATEGORIES]
    offset = clock[0] if clock is not None else None
    if offset is not None and got:
        pid = os.getpid()
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                       "args": {"name": "spans"}})
        for s in got:
            events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                           "tid": SPAN_TID, "ts": s.start_ns * 1e-3 + offset,
                           "dur": (s.end_ns - s.start_ns) * 1e-3,
                           "args": {"call": s.call, **s.counts}})
        with open(path, "w") as f:
            json.dump(trace, f)
    table = {"clock": None if clock is None else {"offset_us": clock[0], "spread_us": clock[1]},
             "dropped": _dropped,
             "spans": span_table(got, Busy(dev) if dev else None, offset)}
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(table, f, indent=1)


@contextlib.contextmanager
def device_trace(logdir: str, host: bool = True) -> Iterator[torch.profiler.profile]:
    """Trace the card's activity (and the host's calls when ``host``) for
    the steps run inside the context, and write a Chrome trace
    ``trace.json`` under ``logdir`` (view it in Perfetto or
    ``chrome://tracing``) with the program's spans as a track of their
    own, and ``spans.json``: by span name the calls, total and self
    milliseconds, the counters, and the card's idle milliseconds under the
    span and while it was the innermost (null where the trace holds no
    card activity or the anchors do not pair; ``clock`` gives the offset
    and its spread).  Yields the profiler, whose ``key_averages()``
    tabulate the same events.  On the card's machine ``torch.profiler``
    records the card's activity in the first profiling session of a
    process only: trace in a fresh process."""
    acts = []
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if not acts:
        raise ValueError("device_trace: nothing to trace (host=False and no CUDA device)")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    first, first_anchor = len(_record), len(_anchors)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        _write_spans(logdir, first, first_anchor)


class Throughput:
    """Env-steps/s meter with warm-up exclusion.

    >>> meter = Throughput(batch=4096, steps_per_call=256)
    >>> meter.start(); run(); meter.stop(calls=4)
    >>> meter.steps_per_sec

    ``device`` (default ``"cuda"``, which raises where CUDA is absent;
    ``"cpu"`` needs no synchronization) is synchronized at ``start()`` and
    ``stop()``, so the meter times the device's work."""

    def __init__(self, batch: int, steps_per_call: int, device="cuda"):
        self.batch = batch
        self.steps_per_call = steps_per_call
        self.device = check_device(device)
        self._tic: Optional[float] = None
        self.elapsed = 0.0
        self.calls = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._tic = time.perf_counter()

    def stop(self, calls: int = 1):
        if self._tic is None:
            raise RuntimeError("Throughput.stop() before start()")
        self._sync()
        self.elapsed += time.perf_counter() - self._tic
        self.calls += calls
        self._tic = None

    @property
    def env_steps(self) -> int:
        return self.batch * self.steps_per_call * self.calls

    @property
    def steps_per_sec(self) -> float:
        return self.env_steps / self.elapsed if self.elapsed else float("nan")
