"""Host calls that wait for the card an iteration: synchronizes
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) and ``cudaMemcpy*`` calls in which a
device-to-host copy ended, starting inside a ``fused.iteration`` span on
the trace's clock, over the iterations.  A ``.cpu()`` into pageable
memory counts its copy and its synchronize."""
from benchmark.harness import spans


def read(rec):
    its = spans.on_trace(rec, "fused.iteration")
    if not its:
        return None
    return spans.inside(spans.blocking_calls(rec), its) / len(its)
