"""The learner's host time a minibatch, in us: the mean duration of the
program's ``learner.minibatch`` spans (the advantage statistics, the grad
step's launch, the clip and Adam) over the traced window, by the host's
clock."""
from benchmark.harness import spans


def read(rec):
    return spans.mean_us(rec, "learner.minibatch")
