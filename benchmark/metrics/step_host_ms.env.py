"""The vector env's host time a ``step``, in ms: the mean duration of the
program's ``env.step`` spans over the traced window (the actions to the
card, the eager step's issue, the copy to the host and the ``info``
dict), by the host's clock; the profiler stretches it (``trace_cost``)."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "env.step")
    return us * 1e-3 if us is not None else None
