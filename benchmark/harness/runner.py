"""What run.py asks of a driver's runner, with the defaults most share."""
from __future__ import annotations

import torch


class Runner:
    """A driver's ``setup(ctx)`` returns one: the program's state for the
    cell, built from the seed and warmed up.  ``call()`` is one closed-loop
    call, returning once its answer is on the host; ``work_per_call`` counts
    its env-steps.  ``check(rec)`` runs after the window: it frees the
    program's state and returns the numbers compared with the reference,
    ``[{"name", "value", "limit"}]``, correct where each value is at most
    its limit."""

    work_per_call = 0
    failed = 0

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.limits = ctx.workload["limits"]

    def call(self) -> None:
        raise NotImplementedError

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def check(self, rec: dict) -> list:
        raise NotImplementedError

    def numbers(self, values: dict) -> list:
        """``values`` by name, each beside the cell's limit."""
        return [{"name": k, "value": float(v), "limit": float(self.limits[k])}
                for k, v in values.items()]


def free_cuda():
    """Return the caching allocator's blocks once the program's state is
    dropped, so that the reference finds the card's memory."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
