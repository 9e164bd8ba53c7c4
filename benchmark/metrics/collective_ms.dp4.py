"""The card's time in NCCL kernels a call on rank 0, in ms: the device time
of the kernels named ``ncclDevKernel_*`` / ``ncclKernel_*`` in the traced
window over the calls.  An NCCL kernel starts when its rank reaches the
collective and ends when every rank has sent its part, so this time holds
rank 0's wait for the slowest rank as well as the transfer; None where the
window ran no NCCL kernel."""
from benchmark.harness import layer
from benchmark.harness import trace as tr

PATTERN = r"nccl(Dev)?Kernel"


def read(rec):
    ks = layer.window_events(rec, PATTERN)
    return layer.per_call_ms(rec, tr.total_us(ks)) if ks else None
