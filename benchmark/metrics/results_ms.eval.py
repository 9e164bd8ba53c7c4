"""Evaluation's host work a call, in ms: the mean duration of the
program's ``evaluate.results`` spans over the traced window (the copy of
the ``[4, T, B]`` planes to the host, which waits for K1b, their
transposes and ``cohort_stats``), by the host's clock."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "evaluate.results")
    return us * 1e-3 if us is not None else None
