"""The reduction of a device trace to per-layer numbers.

A trace here is a list of :class:`Event` (name, kind, start and end in
microseconds): the card's kernels and copies as ``torch.profiler`` records
them, and the host's CUDA calls that issue them (a run records no host
operator, so the profiler does not stretch the host's time).  Every
function is plain arithmetic on such lists, so the CPU tests check it on
synthetic events.
"""
from __future__ import annotations

import re
from typing import Iterable, List, NamedTuple, Optional

KERNEL, COPY, MEMSET, HOST = "kernel", "copy", "memset", "host"
NO_CUDA_CALL = "(host code, no CUDA call)"  # a gap's name where no CUDA call ran


class Event(NamedTuple):
    name: str
    kind: str  # KERNEL | COPY | MEMSET | HOST
    start: float  # us
    end: float  # us


def device(events: Iterable[Event]) -> List[Event]:
    return [e for e in events if e.kind != HOST]


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def clip(events: Iterable[Event], lo: float, hi: float) -> List[Event]:
    """The events' parts inside ``[lo, hi]``."""
    return [e._replace(start=max(e.start, lo), end=min(e.end, hi))
            for e in events if e.end > lo and e.start < hi]


def window(events: List[Event]) -> Optional[tuple]:
    """(start, end) of the traced window: from the card's first kernel or
    copy to its last one's end (the calls run back to back, so only the
    first call's host work before its first launch and the last one's
    after its last are left out); None without device events."""
    dev = device(events)
    if not dev:
        return None
    return min(e.start for e in dev), max(e.end for e in dev)


def busy_us(events: List[Event], lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` in which some kernel or copy ran."""
    return union_us((e.start, e.end) for e in clip(device(events), lo, hi))


def idle_share(events: List[Event], lo: float, hi: float) -> float:
    """The share of ``[lo, hi]`` in which the card ran nothing."""
    if hi <= lo:
        raise ValueError("empty window")
    return 1.0 - busy_us(events, lo, hi) / (hi - lo)


def matching(events: Iterable[Event], pattern: str, kind: str = KERNEL) -> List[Event]:
    rx = re.compile(pattern)
    return [e for e in events if e.kind == kind and rx.search(e.name)]


def total_us(events: Iterable[Event]) -> float:
    return sum(e.end - e.start for e in events)


def copy_us(events: Iterable[Event], direction: str = "DtoH") -> float:
    """Summed time of the card's copies in ``direction`` (DtoH, HtoD, DtoD)."""
    return total_us(e for e in events if e.kind == COPY and direction in e.name)


def gaps(events: List[Event], lo: float, hi: float) -> List[tuple]:
    """The ``(start, end)`` intervals of ``[lo, hi]`` in which the card ran
    nothing."""
    out, cur = [], lo
    for a, b in sorted((e.start, e.end) for e in clip(device(events), lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out


def host_at(events: List[Event], times: List[float]) -> List[str]:
    """For each of the ascending ``times``, the innermost host event
    running then (the shortest that covers it), or :data:`NO_CUDA_CALL`:
    one sweep over the host events sorted by start."""
    host = sorted((e for e in events if e.kind == HOST), key=lambda e: e.start)
    out, active, j = [], [], 0
    for t in times:
        while j < len(host) and host[j].start <= t:
            active.append(host[j])
            j += 1
        active = [e for e in active if e.end >= t]
        best = min(active, key=lambda e: e.end - e.start, default=None)
        out.append(best.name if best is not None else NO_CUDA_CALL)
    return out


def breakdown(events: List[Event], lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time summed
    by the host activity that overlaps each gap's midpoint, both in
    seconds, the ``top`` largest of each."""
    by_op = {}
    for e in clip(device(events), lo, hi):
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.end - e.start)
    idle = gaps(events, lo, hi)
    by_host = {}
    for (a, b), name in zip(idle, host_at(events, [0.5 * (a + b) for a, b in idle])):
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    rank = lambda d: [[k[:120], v * 1e-6]
                      for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def from_profiler(prof) -> List[Event]:
    """The events of a stopped ``torch.profiler.profile``: the card's
    kernels, copies and memsets, and the host's events (its CUDA calls)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            name = e.name
            kind = (COPY if name.startswith("Memcpy")
                    else MEMSET if name.startswith("Memset") else KERNEL)
            out.append(Event(name, kind, a, b))
        elif e.device_type == DeviceType.CPU:
            out.append(Event(e.name, HOST, a, b))
    return out
