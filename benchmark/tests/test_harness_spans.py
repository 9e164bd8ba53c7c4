"""The readers of the program's spans on a synthetic run: two training
iterations, two cohort calls and two rollouts on the span clock, the
trace's events 100 us ahead of it, and one anchor a top-level span."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.harness import spans as sp
from benchmark.harness.trace import COPY, HOST, KERNEL, Event
from simglucose_tpu_torch.utils import profiling
from simglucose_tpu_torch.utils.profiling import Span

BASE_NS = 10 ** 12  # the span clock at the synthetic run's start
OFF = 100.0  # trace us = span-clock us - BASE_NS / 1000 + OFF
ITER_US = 1000.0


def ns(us: float) -> int:
    return BASE_NS + int(round(us * 1000))


def training():
    """Two iterations, each: the rollout, GAE, the learner of two
    minibatches (240 us each); on the trace 3 launches, 2 waits, and the
    card busy 150 + 3 us under the learner's 500."""
    out, marks, ev = [], [], []
    for k in range(2):
        b = k * ITER_US
        top = len(out)
        out += [Span("fused.iteration", ns(b), ns(b + 800), -1, k, {}),
                Span("fused.rollout", ns(b + 10), ns(b + 100), top, k, {}),
                Span("rollout", ns(b + 20), ns(b + 90), top + 1, k, {}),
                Span("gae", ns(b + 110), ns(b + 120), top, k, {}),
                Span("fused.learner", ns(b + 200), ns(b + 700), top, k, {}),
                Span("learner.minibatch", ns(b + 200), ns(b + 440), top + 4, k, {}),
                Span("learner.minibatch", ns(b + 450), ns(b + 690), top + 4, k, {})]
        marks.append((ns(b), ns(b + 2)))
        t = b + OFF
        ev += [Event("cudaStreamQuery", HOST, t + 0.5, t + 1.5),
               Event("cudaLaunchKernel", HOST, t + 30, t + 33),
               Event("cudaLaunchKernel", HOST, t + 250, t + 253),
               Event("cudaLaunchKernelExC", HOST, t + 500, t + 503),
               Event("cudaLaunchKernel", HOST, t + 900, t + 903),  # between iterations
               Event("cudaStreamSynchronize", HOST, t + 600, t + 610),
               Event("cudaMemcpyAsync", HOST, t + 650, t + 660),  # waits: DtoH ends in it
               Event("cudaMemcpyAsync", HOST, t + 300, t + 305),  # HtoD: no wait
               Event("cudaStreamSynchronize", HOST, t + 950, t + 960),  # outside
               Event("rollout_nn_kernel", KERNEL, t + 30, t + 150),
               Event("ppo_grad_kernel", KERNEL, t + 250, t + 400),
               Event("Memcpy HtoD (Pageable -> Device)", COPY, t + 301, t + 304),
               Event("Memcpy DtoH (Device -> Pageable)", COPY, t + 652, t + 655)]
    return {"spans": out, "anchors": marks, "events": ev, "trace_window_us": (OFF, 2000.0)}


def cohort():
    out = []
    for k, (eng, frame) in enumerate(((20.0, 5.0), (30.0, 7.0))):
        b = k * 100_000.0
        top = len(out)
        out += [Span("simulate", ns(b), ns(b + 40_000), -1, k, {}),
                Span("simulate_cohort", ns(b), ns(b + eng * 1000), top, k, {}),
                Span("rollout", ns(b + 10), ns(b + 500), top + 1, k, {}),
                Span("cohort.frame", ns(b + 32_000), ns(b + 32_000 + frame * 1000), top, k, {})]
    return {"spans": out, "anchors": [], "events": []}


def rollouts():
    out = [Span("rollout", ns(0), ns(100), -1, 0, {}),
           Span("rollout", ns(1000), ns(1300), -1, 1, {}),
           Span("wrapper", ns(5000), ns(7000), -1, 2, {}),
           Span("rollout", ns(5000), ns(6000), 2, 2, {})]  # not at the top level
    return {"spans": out, "anchors": [], "events": []}


READ = {
    "iter_host_ms.train": (training, 0.8),
    "launches.train": (training, 3.0),
    "syncs.train": (training, 2.0),
    "minibatch_host_us.train": (training, 240.0),
    "learner_idle_ms.train": (training, (500 - 150 - 3) * 1e-3 * 2 / 2),
    "engine_host_ms.cohort": (cohort, 25.0),
    "frame_ms.cohort": (cohort, 6.0),
    "rollout_host_us.sim": (rollouts, 200.0),
}
ON_TRACE = {"launches.train", "syncs.train", "learner_idle_ms.train"}


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_returns_its_definition(name):
    make, want = READ[name]
    assert run.load_module("metrics", name).read(make()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_returns_none_without_spans(name):
    make, _ = READ[name]
    rec = make()
    rec["spans"] = []
    assert run.load_module("metrics", name).read(rec) is None
    rec = make()
    rec["spans"] = [s._replace(name="other") for s in rec["spans"]]
    assert run.load_module("metrics", name).read(rec) is None


@pytest.mark.parametrize("name", sorted(ON_TRACE))
def test_trace_clock_reader_returns_none_where_anchors_do_not_pair(name):
    rec = training()
    rec["anchors"] = rec["anchors"][:1]
    assert run.load_module("metrics", name).read(rec) is None
    rec = training()
    rec["events"] = [e for e in rec["events"] if e.name != "cudaStreamQuery"]
    assert run.load_module("metrics", name).read(rec) is None


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_reads_the_programs_record(name, monkeypatch):
    """A run hands no spans: the reader takes the program's record, empty
    outside a profiler session; and a program without spans (an older
    checkout) gives None, not an error."""
    profiling.clear_spans()
    rec = {k: v for k, v in READ[name][0]().items() if k not in ("spans", "anchors")}
    assert run.load_module("metrics", name).read(rec) is None
    monkeypatch.setattr(sp, "_profiling", lambda: None)
    assert run.load_module("metrics", name).read(rec) is None


def test_the_anchors_place_the_spans_on_the_trace():
    rec = training()
    its = sp.on_trace(rec, "fused.iteration")
    assert its == [pytest.approx((OFF, OFF + 800)), pytest.approx((OFF + 1000, OFF + 1800))]
    assert sp.inside([OFF - 1, OFF, OFF + 800, OFF + 801, OFF + 1500], its) == 3
