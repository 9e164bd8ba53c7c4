"""The program's spans (``simglucose_tpu_torch/utils/profiling.py``) for
the per-layer readers.

The program records spans only while a ``torch.profiler`` session is
active: in a ``--trace 1`` run, the traced window's calls.  A span's
times are on the host's ``perf_counter_ns`` clock; the program's anchors
(one a top-level span) put them on the trace's clock through
``profiling.trace_offset_us``.  Every function returns None where there
is nothing to read: a program without spans (an older checkout), a
window that recorded none, or anchors that do not pair with the trace's.
A test hands a run's spans and anchors in ``rec["spans"]`` and
``rec["anchors"]``; a run leaves them out and the program's record is read.
"""
from __future__ import annotations

import bisect

from benchmark.harness import trace as tr

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _profiling():
    try:
        from simglucose_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def recorded(rec: dict):
    """The run's spans, or None."""
    if "spans" in rec:
        return rec["spans"] or None
    prof = _profiling()
    return (prof.spans() or None) if prof is not None else None


def named(rec: dict, name: str, top: bool = False) -> list:
    """The spans called ``name`` (only those at the top level with ``top``)."""
    return [s for s in recorded(rec) or () if s.name == name and (not top or s.parent < 0)]


def mean_us(rec: dict, name: str, top: bool = False):
    """The mean duration of the spans called ``name`` in microseconds."""
    got = named(rec, name, top)
    return sum(s.end_ns - s.start_ns for s in got) * 1e-3 / len(got) if got else None


def on_trace(rec: dict, name: str):
    """The ``(start, end)`` microseconds on the trace's clock of the spans
    called ``name``; None where there are none or the clock is unknown."""
    got = named(rec, name)
    prof = _profiling()
    if not got or prof is None:
        return None
    marks = rec["anchors"] if "anchors" in rec else prof.anchors()
    clock = prof.trace_offset_us(((e.name, e.start, e.end) for e in rec["events"]
                                  if e.kind == tr.HOST), marks)
    if clock is None:
        return None
    off = clock[0]
    return [(s.start_ns * 1e-3 + off, s.end_ns * 1e-3 + off) for s in got]


def inside(points: list, spans: list) -> int:
    """How many of ``points`` (microseconds) fall inside one of ``spans``
    (disjoint ``(start, end)`` intervals)."""
    pts = sorted(points)
    return sum(bisect.bisect_right(pts, b) - bisect.bisect_left(pts, a) for a, b in spans)


def host_calls(rec: dict, names: tuple) -> list:
    """The start of each host event called one of ``names``."""
    return [e.start for e in rec["events"] if e.kind == tr.HOST and e.name in names]


def blocking_calls(rec: dict) -> list:
    """The start of each host call that waits for the card: a synchronize
    (:data:`SYNCS`), or a ``cudaMemcpy*`` in which a device-to-host copy
    on the card ended (a copy into pageable memory, or a synchronous one)."""
    dtoh = sorted(e.end for e in rec["events"] if e.kind == tr.COPY and "DtoH" in e.name)
    out = host_calls(rec, SYNCS)
    for e in rec["events"]:
        if e.kind == tr.HOST and e.name.startswith("cudaMemcpy"):
            if bisect.bisect_right(dtoh, e.end) > bisect.bisect_left(dtoh, e.start):
                out.append(e.start)
    return out


def idle_us(rec: dict, spans: list) -> float:
    """Microseconds of ``spans`` (disjoint ``(start, end)`` intervals) in
    which the card ran no kernel, copy or memset."""
    busy = []  # the union of the card's intervals, merged
    for a, b in sorted((e.start, e.end) for e in tr.device(rec["events"])):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    starts = [a for a, _ in busy]
    total = 0.0
    for lo, hi in spans:
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            covered += max(0.0, min(hi, busy[i][1]) - max(lo, busy[i][0]))
            i += 1
        total += (hi - lo) - covered
    return total
