"""Kernel launches an iteration: the trace's kernel-launch host calls
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``) that
start inside a ``fused.iteration`` span on the trace's clock, over the
iterations."""
from benchmark.harness import spans


def read(rec):
    its = spans.on_trace(rec, "fused.iteration")
    if not its:
        return None
    return spans.inside(spans.host_calls(rec, spans.LAUNCHES), its) / len(its)
