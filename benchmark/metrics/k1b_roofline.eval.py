"""K1b's share of its roofline in evaluation: the least time of its
launches at the cell's shape (:mod:`benchmark.counts.k1b` with the six
observation planes in place of the learner rows, as evaluation's launch
writes them) over the device time of the kernels named
``rollout_nn_kernel``.  The count holds the action noise's three
transcendentals, which the mean action does not draw; the launch is bound
by its FLOP, which they leave unchanged."""
from benchmark.counts import k1b
from benchmark.harness import layer

PATTERN = r"rollout_nn_kernel"


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    T = int(wl["hours"] * 60) // conf["sample_time"]
    return layer.roofline_pct(rec, PATTERN, k1b.count(wl["batch"], T, conf["hidden"],
                                                      conf["sample_time"],
                                                      emit_learner_rows=False))
