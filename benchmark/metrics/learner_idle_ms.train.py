"""The card's idle time under the learner an iteration, in ms: the time
inside the program's ``fused.learner`` spans, on the trace's clock, in
which the card ran no kernel, copy or memset, over the iterations
(``fused.iteration`` spans)."""
from benchmark.harness import spans


def read(rec):
    learner = spans.on_trace(rec, "fused.learner")
    its = spans.named(rec, "fused.iteration")
    if not learner or not its:
        return None
    return spans.idle_us(rec, learner) * 1e-3 / len(its)
