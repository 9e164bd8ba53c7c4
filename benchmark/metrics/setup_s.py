"""Seconds from the start of the process to the first timed call: imports,
the kernels' build or load, the program's state, the warm-up calls."""


def read(rec):
    return rec["setup_s"]
