"""Shared arithmetic of the per-layer readers over a traced window."""
from __future__ import annotations

from benchmark.harness import peaks
from benchmark.harness import trace as tr


def window_events(rec: dict, pattern: str = None) -> list:
    """The traced window's events (clipped to it); with ``pattern`` only
    the kernels whose name it matches."""
    lo, hi = rec["trace_window_us"]
    ev = tr.clip(rec["events"], lo, hi)
    return ev if pattern is None else tr.matching(ev, pattern)


def window_s(rec: dict) -> float:
    lo, hi = rec["trace_window_us"]
    return (hi - lo) * 1e-6


def roofline_pct(rec: dict, pattern: str, count: dict, per_launch_of: str = None):
    """100 x the least time of the matched kernels' launches (``count`` a
    launch, one launch per kernel matching ``per_launch_of``, default the
    pattern itself) over their device time; None where none ran."""
    ks = window_events(rec, pattern)
    if not ks:
        return None
    n = len(window_events(rec, per_launch_of)) if per_launch_of else len(ks)
    return 100.0 * n * peaks.bound_s(**count) / (tr.total_us(ks) * 1e-6)


def mfu_pct(rec: dict, flop_per_call: float) -> float:
    """100 x the frozen FLOP of the untraced window's calls over that
    window, by the host's clock, at the float32 peak."""
    win = rec["untraced"]
    return 100.0 * win["calls"] * flop_per_call / (win["window_s"] * peaks.F32_FLOP_PER_S)


def idle_pct(rec: dict) -> float:
    """The share of the untraced window in which the card ran nothing:
    1 - the card's busy time a call in the traced window (the union of its
    kernels and copies over the traced calls; the profiler stretches the
    host's time between them, not the card's work) x the untraced
    window's calls a second."""
    lo, hi = rec["trace_window_us"]
    busy_per_call_s = tr.busy_us(rec["events"], lo, hi) * 1e-6 / rec["calls"]
    win = rec["untraced"]
    return 100.0 * (1.0 - busy_per_call_s * win["calls"] / win["window_s"])


def per_call_ms(rec: dict, us: float) -> float:
    return us * 1e-3 / rec["calls"]
