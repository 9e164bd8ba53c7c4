"""K1b's share of its roofline: the least time of its launches at the
cell's shape (:mod:`benchmark.counts.k1b`, the learner rows emitted)
over the device time of the kernels named ``rollout_nn_kernel``."""
from benchmark.counts import k1b
from benchmark.harness import layer

PATTERN = r"rollout_nn_kernel"


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    return layer.roofline_pct(rec, PATTERN, k1b.count(wl["batch"], wl["rollout_steps"],
                                                      conf["hidden"], conf["sample_time"]))
