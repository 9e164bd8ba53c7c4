"""The port's profiling helpers (``simglucose_tpu_torch/utils/profiling.py``)
against the JAX package's (``simglucose_tpu/utils/profiling.py``).

``Throughput`` keeps the JAX arithmetic: both meters read the same
monkeypatched clock and must agree exactly on ``env_steps``,
``elapsed`` and ``steps_per_sec``, and raise the same RuntimeError on a
``stop()`` before ``start()``.  ``device_trace`` writes a Chrome trace on
the CPU (on the card it also records CUDA activity; ``chip_smoke.py``
checks that its trace names the rollout kernel)."""
import json
import time

import pytest
import torch

from simglucose_tpu.utils import profiling as jprof
from simglucose_tpu_torch import utils as tutils
from simglucose_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


@pytest.mark.parametrize("ticks, calls", [
    ((1.0, 1.25, 3.0, 3.5), (4, 2)),
    ((0.0, 0.003, 0.003, 0.004), (1, 1)),
])
def test_throughput_matches_jax(monkeypatch, ticks, calls):
    meters = {"jax": jprof.Throughput(batch=4096, steps_per_call=256),
              "port": tprof.Throughput(batch=4096, steps_per_call=256, device="cpu")}
    for name, meter in meters.items():
        monkeypatch.setattr(time, "perf_counter", _Clock(ticks))
        for c in calls:
            meter.start()
            meter.stop(calls=c)
    j, p = meters["jax"], meters["port"]
    assert p.env_steps == j.env_steps == 4096 * 256 * sum(calls)
    assert p.elapsed == j.elapsed
    assert p.steps_per_sec == j.steps_per_sec


def test_throughput_errors_and_empty_meter_match_jax():
    for meter in (jprof.Throughput(8, 2), tprof.Throughput(8, 2, device="cpu")):
        with pytest.raises(RuntimeError, match=r"Throughput.stop\(\) before start\(\)"):
            meter.stop()
        assert meter.env_steps == 0 and meter.steps_per_sec != meter.steps_per_sec  # nan


def test_throughput_defaults_to_the_card():
    assert tutils.Throughput is tprof.Throughput and tutils.device_trace is tprof.device_trace
    if torch.cuda.is_available():
        assert tprof.Throughput(1, 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tprof.Throughput(1, 1)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.device_trace(str(tmp_path)) as prof:
        (a @ a).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
