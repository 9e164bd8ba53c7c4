"""The share of the untraced window in which the card ran no kernel and
no copy, in the vector env's cell: 1 - (the card's busy time a call, the
union of its kernel and copy intervals in the traced window over the
traced calls) x (the untraced window's calls a second)."""
from benchmark.harness import layer


def read(rec):
    return layer.idle_pct(rec)
