"""The all-gather's bus bandwidth as a share of NVLink 4's 450 GB/s a
direction (:mod:`benchmark.harness.links`): (n - 1) / n x the bytes the
cohort's calls gather (:mod:`benchmark.counts.cohort_gather`, frozen) over
the device time of the NCCL all-gather kernels in the traced window.  The
kernels' time holds the wait for the slowest rank, so a skew between the
ranks reads as a lower share; None where no all-gather kernel ran."""
from benchmark.counts import cohort_gather
from benchmark.harness import layer, links
from benchmark.harness import trace as tr

PATTERN = r"nccl(Dev)?Kernel_AllGather"


def read(rec):
    ks = layer.window_events(rec, PATTERN)
    if not ks:
        return None
    wl, conf = rec["workload"], rec["config"]
    n = conf["assumed"]["ranks"]
    gathered = cohort_gather.count(wl["patients"], wl["hours"] * 60 // conf["sample_time"],
                                   n)["bytes"]
    return links.busbw_pct(gathered * rec["calls"], n, tr.total_us(ks) * 1e-6)
