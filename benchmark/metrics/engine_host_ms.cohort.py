"""The host engine's time a call, in ms: the mean duration of the
program's ``simulate_cohort`` spans (tables and packing, the rollout's
launch, the risk planes and reward replay, the copy to the host) over the
traced window, by the host's clock."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "simulate_cohort")
    return us * 1e-3 if us is not None else None
