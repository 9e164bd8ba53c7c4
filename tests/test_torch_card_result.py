"""The cohort's result on the card: where it lives and what it equals.

These tests need a CUDA card (marker ``card``): elsewhere they skip, which
the fixture decides.  Nothing here imports JAX, so on the card they run
without the suite's JAX set-up in ``conftest.py``::

    python -m pytest tests/test_torch_card_result.py -q -p no:cacheprovider --noconftest -o addopts=""
"""
from datetime import timedelta

import numpy as np
import pytest
import torch

from simglucose_tpu_torch.sim import engine
from simglucose_tpu_torch.utils import profiling as tprof

NAMES = ["adolescent#001", "adult#005", "child#003"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fetch_counts(**kw):
    """``simulate_cohort(**kw)`` with spans on, and the counters of its
    ``cohort.fetch`` spans."""
    tprof.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            res = engine.simulate_cohort(**kw)
        return res, [s.counts for s in tprof.spans() if s.name == "cohort.fetch"]
    finally:
        tprof.clear_spans()


@pytest.mark.card
def test_one_call_result_is_one_page_locked_tensor(card, monkeypatch):
    """A horizon of one call: every plane of the result is a view of one
    page-locked ``[8, T, B]`` tensor, the reset row is page-locked too, both
    fetches went to page-locked memory whole, the planes are writable, and
    the result equals a run of the same key in calls of 17 steps bit for
    bit."""
    kw = dict(sim_time=timedelta(hours=2), patient_names=NAMES, scenario_seed=3, cgm_seed=5,
              device=card)
    one, fetch = _fetch_counts(**kw)
    assert len(fetch) == 2 and all(c["pinned_bytes"] == c["bytes"] > 0 for c in fetch)
    bg, reward = one.traj.BG, one.reward
    T, B = bg.shape
    assert (T, B) == (40, len(NAMES))
    for plane in (*one.traj, reward, one.reset.BG):
        assert torch.from_numpy(plane).is_pinned()
    # BG is plane 0 and the reward plane 7 of the one [8, T, B] tensor
    assert reward.ctypes.data - bg.ctypes.data == 7 * T * B * bg.itemsize
    assert bg.flags.writeable and reward.flags.writeable

    monkeypatch.setattr(engine, "MAX_STEPS_PER_CALL", 17)
    cut, fetch = _fetch_counts(**kw)
    assert len(fetch) == 4 and all(c["pinned_bytes"] == c["bytes"] > 0 for c in fetch)
    for a, b in zip(one.traj + one.reset, cut.traj + cut.reset):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one.reward, cut.reward)


@pytest.mark.card
def test_dropped_results_reuse_the_host_cache(card):
    """A caller that drops each result before the next call pins no new
    memory: after a first call, later calls of the same shape take their
    page-locked blocks back from PyTorch's host cache."""
    kw = dict(sim_time=timedelta(hours=2), patient_names=NAMES, cgm_seed=5, device=card)
    engine.simulate_cohort(scenario_seed=0, **kw)
    before = torch.cuda.host_memory_stats()
    for seed in range(1, 4):
        res = engine.simulate_cohort(scenario_seed=seed, **kw)
        assert torch.from_numpy(res.traj.BG).is_pinned()
        del res
    after = torch.cuda.host_memory_stats()
    assert after["num_host_alloc"] == before["num_host_alloc"]
    assert after["allocated_bytes.current"] == before["allocated_bytes.current"]
