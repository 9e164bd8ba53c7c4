"""The vector env's copy to the host a ``step``, in ms: the mean duration
of the program's ``env.fetch`` spans over the traced window, by the
host's clock.  The copy waits for the step's work on the card, so the
span holds the card's lag behind the host's issue too."""
from benchmark.harness import spans


def read(rec):
    us = spans.mean_us(rec, "env.fetch")
    return us * 1e-3 if us is not None else None
