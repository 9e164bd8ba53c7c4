"""K1a's share of its roofline: the least time of its launches at the
cell's shape (:mod:`benchmark.counts.k1a`: operations, transcendentals or
bytes, whichever bounds) over the device time of the kernels named
``rollout_kernel`` in the trace."""
from benchmark.counts import k1a
from benchmark.harness import layer

PATTERN = r"(?<![A-Za-z0-9_])rollout_kernel"


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    return layer.roofline_pct(rec, PATTERN, k1a.count(wl["batch"], wl["steps"],
                                                      conf["sample_time"], wl["controller"]))
