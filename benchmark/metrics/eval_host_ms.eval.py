"""An evaluation's host time, in ms: the mean duration of the program's
``evaluate`` spans over the traced window (the whole
``evaluate_policy_kernel``: the cohort's preparation, K1b's launch, the
copy of the planes and the statistics), by the host's clock."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "evaluate")
    return us * 1e-3 if us is not None else None
