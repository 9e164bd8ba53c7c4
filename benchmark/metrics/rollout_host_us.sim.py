"""The rollout wrapper's host time a call, in us: the mean duration of the
program's top-level ``rollout`` spans (the config's checks, the output
buffers, the kernel's launch, the result's views; and the span's anchor)
over the traced window, by the host's clock."""
from benchmark.harness import spans


def read(rec):
    return spans.mean_us(rec, "rollout", top=True)
