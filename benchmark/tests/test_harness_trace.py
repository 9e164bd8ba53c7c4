"""The trace arithmetic on synthetic event lists."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.harness import layer
from benchmark.harness import trace as tr
from benchmark.harness.trace import COPY, HOST, KERNEL, Event


def events():
    return [
        Event("cudaMemcpyAsync", HOST, 12.0, 18.0),
        Event("cudaLaunchKernel", HOST, 60.0, 75.0),
        Event("cudaStreamSynchronize", HOST, 90.0, 100.0),
        Event("(anonymous namespace)::rollout_kernel(sgt::RolloutCfg)", KERNEL, 0.0, 10.0),
        Event("(anonymous namespace)::rollout_kernel(sgt::RolloutCfg)", KERNEL, 5.0, 12.0),
        Event("rollout_nn_kernel(sgt::RolloutCfg)", KERNEL, 20.0, 30.0),
        Event("Memcpy DtoH (Device -> Pageable)", COPY, 30.0, 34.0),
        Event("Memcpy HtoD (Pageable -> Device)", COPY, 40.0, 41.0),
        Event("ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", KERNEL, 80.0, 90.0),
    ]


def test_union_and_idle_share():
    assert tr.union_us([(0, 10), (5, 12), (20, 30), (30, 34)]) == 26.0
    ev = events()
    assert tr.window(ev) == (0.0, 90.0)  # the card's first event to its last
    assert tr.window([e for e in ev if e.kind == HOST]) is None
    assert tr.busy_us(ev, 0.0, 100.0) == pytest.approx(12 + 14 + 1 + 10)
    assert tr.idle_share(ev, 0.0, 100.0) == pytest.approx(1 - 37 / 100)
    assert tr.busy_us(ev, 6.0, 25.0) == pytest.approx(6 + 5)  # clipped to the window


def test_copies_and_kernels_by_pattern():
    ev = events()
    assert tr.copy_us(ev, "DtoH") == 4.0 and tr.copy_us(ev, "HtoD") == 1.0
    k1a = run.load_module("metrics", "k1a_roofline").PATTERN
    assert tr.total_us(tr.matching(ev, k1a)) == 17.0  # not rollout_nn_kernel
    assert tr.total_us(tr.matching(ev, r"rollout_nn_kernel")) == 10.0
    k3 = run.load_module("metrics", "k3_roofline").PATTERN
    assert tr.matching(ev, k3) == []


def test_per_call_readers():
    rec = {"events": events(), "trace_window_us": (0.0, 100.0), "calls": 2}
    assert run.load_module("metrics", "d2h_ms.cohort").read(rec) == pytest.approx(4e-3 / 2)
    # 37 us busy over 2 traced calls; the untraced window ran 10 calls in 500 us
    rec["untraced"] = {"calls": 10, "window_s": 500e-6}
    assert run.load_module("metrics", "device_idle.cohort").read(rec) == pytest.approx(
        100 * (1 - 18.5 * 10 / 500))
    rec["events"] = [e for e in rec["events"] if "Memcpy DtoH" not in e.name]
    assert run.load_module("metrics", "d2h_ms.cohort").read(rec) is None


def test_mfu_reads_the_untraced_window():
    rec = {"untraced": {"calls": 4, "window_s": 2.0}, "calls": 1, "trace_window_us": (0.0, 1.0)}
    assert layer.mfu_pct(rec, 67e12 * 0.25) == pytest.approx(100 * 4 * 0.25 / 2.0)


def test_roofline_counts_launches_by_their_own_pattern():
    rec = {"events": events(), "trace_window_us": (0.0, 100.0), "calls": 2}
    count = {"flop": 67e12 * 1e-6, "bytes": 0.0}  # 1 us at the peak a launch
    assert layer.roofline_pct(rec, r"rollout_kernel|rollout_nn", count,
                              per_launch_of=r"rollout_nn") == pytest.approx(100 * 1 / 27)
    assert layer.roofline_pct(rec, r"no_such_kernel", count) is None


def test_gaps_named_by_the_host():
    ev = events()
    assert tr.gaps(ev, 0.0, 100.0) == [(12.0, 20.0), (34.0, 40.0), (41.0, 80.0), (90.0, 100.0)]
    assert tr.host_at(ev, [15.0, 37.0, 60.5, 95.0]) == [
        "cudaMemcpyAsync", tr.NO_CUDA_CALL, "cudaLaunchKernel", "cudaStreamSynchronize"]
    bd = tr.breakdown(ev, 0.0, 100.0)
    assert bd["device_ops"][0][0].startswith("(anonymous namespace)::rollout_kernel")
    assert bd["device_ops"][0][1] == pytest.approx(17e-6)
    names = dict(bd["idle_gaps"])
    assert names[tr.NO_CUDA_CALL] == pytest.approx(6e-6)
    assert names["cudaMemcpyAsync"] == pytest.approx(8e-6)
    assert names["cudaLaunchKernel"] == pytest.approx(39e-6)
    assert names["cudaStreamSynchronize"] == pytest.approx(10e-6)


def test_a_share_over_105_percent_raises():
    assert run.held_to_peak("k1a_roofline", "%", 104.9) == 104.9
    assert run.held_to_peak("d2h_ms.cohort", "ms", 500.0) == 500.0
    with pytest.raises(SystemExit):
        run.held_to_peak("k1a_roofline", "%", 105.1)
