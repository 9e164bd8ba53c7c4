"""Profiling and throughput instrumentation.

Counterpart of ``simglucose_tpu/utils/profiling.py:19-60``: a trace
context on ``torch.profiler`` (the card's kernels and copies, and the
host's calls when asked) that writes a Chrome trace, and the env-steps/s
meter of the benches and the trainer CLI.

On the card kernels run asynchronously: when :meth:`Throughput.stop` is
called the work it should time may still be queued.  So a meter given a
CUDA device synchronizes it in :meth:`~Throughput.start` and
:meth:`~Throughput.stop`; it then measures the work done, not the
launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from simglucose_tpu_torch.core.device import check_device


@contextlib.contextmanager
def device_trace(logdir: str, host: bool = True) -> Iterator[torch.profiler.profile]:
    """Trace the card's activity (and the host's calls when ``host``) for
    the steps run inside the context, and write a Chrome trace
    ``trace.json`` under ``logdir`` (view it in Perfetto or
    ``chrome://tracing``).  Yields the profiler, whose ``key_averages()``
    tabulate the same events.  On the card's machine ``torch.profiler``
    records the card's activity in the first profiling session of a
    process only: trace in a fresh process."""
    acts = []
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if not acts:
        raise ValueError("device_trace: nothing to trace (host=False and no CUDA device)")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """Env-steps/s meter with warm-up exclusion.

    >>> meter = Throughput(batch=4096, steps_per_call=256)
    >>> meter.start(); run(); meter.stop(calls=4)
    >>> meter.steps_per_sec

    ``device`` (default ``"cuda"``, which raises where CUDA is absent;
    ``"cpu"`` needs no synchronization) is synchronized at ``start()`` and
    ``stop()``, so the meter times the device's work."""

    def __init__(self, batch: int, steps_per_call: int, device="cuda"):
        self.batch = batch
        self.steps_per_call = steps_per_call
        self.device = check_device(device)
        self._tic: Optional[float] = None
        self.elapsed = 0.0
        self.calls = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._tic = time.perf_counter()

    def stop(self, calls: int = 1):
        if self._tic is None:
            raise RuntimeError("Throughput.stop() before start()")
        self._sync()
        self.elapsed += time.perf_counter() - self._tic
        self.calls += calls
        self._tic = None

    @property
    def env_steps(self) -> int:
        return self.batch * self.steps_per_call * self.calls

    @property
    def steps_per_sec(self) -> float:
        return self.env_steps / self.elapsed if self.elapsed else float("nan")
