"""The whole call's share of the card's float32 peak: K1a's frozen FLOP
count (:mod:`benchmark.counts.k1a`) for every call of the traced run's
untraced window, over that window by the host's clock at 67 TFLOP/s.  The summary's few reductions are not
counted."""
from benchmark.counts import k1a
from benchmark.harness import layer


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    return layer.mfu_pct(rec, k1a.count(wl["batch"], wl["steps"], conf["sample_time"],
                                        wl["controller"])["flop"])
