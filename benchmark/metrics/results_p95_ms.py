"""The 95th percentile of every call's latency in the window, in ms: the
wait of a caller who sends the next request when the last one returned."""
import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec["latencies_s"]) * 1e3, 95))
