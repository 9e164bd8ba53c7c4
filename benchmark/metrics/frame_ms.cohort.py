"""The results frame's time a call, in ms: the mean duration of the
program's ``cohort.frame`` spans (``analysis/report.py::cohort_frame``
over the host's planes) over the traced window, by the host's clock."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "cohort.frame")
    return us * 1e-3 if us is not None else None
