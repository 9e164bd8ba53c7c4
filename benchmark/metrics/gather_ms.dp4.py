"""The host's time in the program's all-gathers a call on rank 0, in ms:
the summed duration of the ``mesh.gather`` spans (``parallel/sharding.py``:
the collective, its copies and the concatenation) over the traced
window's calls, by the host's clock; None for a program without the
span."""
from benchmark.harness import spans


def read(rec):
    got = spans.named(rec, "mesh.gather")
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) * 1e-6 / rec["calls"]
