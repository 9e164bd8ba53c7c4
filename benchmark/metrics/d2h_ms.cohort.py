"""Device-to-host copy time a call, in ms: the trace's DtoH copies in the
window over the calls; None where the window holds no such copy."""
from benchmark.harness import layer
from benchmark.harness import trace as tr


def read(rec):
    us = tr.copy_us(layer.window_events(rec), "DtoH")
    return layer.per_call_ms(rec, us) if us > 0 else None
