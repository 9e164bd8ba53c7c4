"""The trainer's host time an iteration, in ms: the mean duration of the
program's ``fused.iteration`` spans over the traced window (the whole
``train_step``: the rollout's launch, GAE, the learner, the metrics), by
the host's clock; the profiler's callbacks stretch it (``trace_cost``)."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "fused.iteration")
    return us * 1e-3 if us is not None else None
