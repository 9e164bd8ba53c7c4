"""Kernel launches a vector env ``step``: the trace's kernel-launch host
calls (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``)
that start inside an ``env.step`` span on the trace's clock, over the
steps.  The agent's launches lie outside the span and are not counted."""
from benchmark.harness import spans


def read(rec):
    steps = spans.on_trace(rec, "env.step")
    if not steps:
        return None
    return spans.inside(spans.host_calls(rec, spans.LAUNCHES), steps) / len(steps)
