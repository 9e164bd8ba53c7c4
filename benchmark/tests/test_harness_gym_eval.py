"""The cells ``gym_vec.agent4096_step`` and ``ppo.eval4096_1d``: each run on
the CPU at a tiny size and correct; each fails its check with a fault
planted under it; and their per-layer readers on a synthetic traced run
(two vector-env steps and two evaluations on the span clock, the trace's
events 100 us ahead of it, an anchor a top-level span)."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import run
from benchmark.harness.trace import COPY, HOST, KERNEL, Event
from benchmark.tests.conftest import drive
from simglucose_tpu_torch.utils.profiling import Span

TINY = {
    "gym_vec.agent4096_step": dict(num_envs=32, check_lanes=16, check_threads=1, control_steps=20),
    "ppo.eval4096_1d": dict(batch=128, hours=2, check_lanes=32, check_threads=1),
}
# a pump that delivers 3% more than it is told (gym), a policy whose mean
# head is shifted (evaluation): closed loops that take another course
FAULTS = {
    "gym_vec.agent4096_step": """
        from simglucose_tpu_torch.envs import functional as f
        basal = f.pump_basal
        f.pump_basal = lambda p, a: basal(p, a * 1.03)
    """,
    "ppo.eval4096_1d": """
        from simglucose_tpu_torch.ops import rollout as tr
        pack = tr.pack_policy_weights
        def shifted(params):
            buf = pack(params)
            buf[0, 9] += 0.5  # the mean head's bias
            return buf
        tr.pack_policy_weights = shifted
    """,
}


@pytest.fixture
def tree(tiny_tree):
    for cell, cut in TINY.items():
        path = os.path.join(tiny_tree, "benchmark", "workloads", f"{cell}.json")
        with open(path) as f:
            wl = json.load(f)
        wl.update(cut)
        with open(path, "w") as f:
            json.dump(wl, f)
    return tiny_tree


CHECKS = {
    "gym_vec.agent4096_step": {"lanes_off", "bg_gap_median"},
    "ppo.eval4096_1d": {"lanes_off", "bg_gap_median", "stats_off", "stats_gap_median"},
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_new_cell_runs_correct_on_the_cpu(tree, cell):
    res = drive(tree, cell, seconds=1.0)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"cohort_env_steps_per_s", "setup_s"}
    assert set(res["checks"]) == CHECKS[cell]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_new_cell_fails_under_a_planted_fault(tree, cell):
    res = drive(tree, cell, seconds=1.0, patch=FAULTS[cell])
    assert res["correct"] is False
    assert res["checks"]["bg_gap_median"]["value"] > res["checks"]["bg_gap_median"]["limit"]


# what evaluation returns beside its BG traces, each wrong as a slip could
# make it: Kovatchev's LBGI over the whole trace in place of upstream's mean
# over the low samples, the CGM traces transposed, the time in range as a
# fraction, the mean insulin in U/h
RETURNED_FAULTS = {
    "lbgi_over_the_whole_trace": """
        import numpy as np
        from simglucose_tpu_torch.rl import evaluate as ev
        stats = ev.cohort_stats
        def whole_trace(bg):
            out = stats(bg)
            f = 1.509 * (np.log(np.maximum(bg, 1.0)) ** 1.084 - 5.381)
            out["LBGI"] = out["LBGI"] * (f < 0).mean(axis=-1)
            out["risk_index"] = out["LBGI"] + out["HBGI"]
            return out
        ev.cohort_stats = whole_trace
    """,
    "cgm_transposed": """
        from simglucose_tpu_torch.rl import evaluate as ev
        results = ev._results
        def transposed(planes, names):
            out = results(planes, names)
            out["CGM"] = out["CGM"].T
            return out
        ev._results = transposed
    """,
    "time_in_range_as_a_fraction": """
        from simglucose_tpu_torch.rl import evaluate as ev
        stats = ev.cohort_stats
        def fraction(bg):
            out = stats(bg)
            out["percent_in_70_180"] = out["percent_in_70_180"] / 100.0
            return out
        ev.cohort_stats = fraction
    """,
    "insulin_mean_in_u_per_h": """
        from simglucose_tpu_torch.rl import evaluate as ev
        results = ev._results
        def per_hour(planes, names):
            out = results(planes, names)
            out["insulin_mean"] = out["insulin_mean"] * 60.0
            return out
        ev._results = per_hour
    """,
}


@pytest.mark.parametrize("fault", sorted(RETURNED_FAULTS))
def test_the_evaluation_check_reads_what_evaluation_returns(tree, fault):
    """The BG traces right and a returned value wrong: the BG checks pass,
    the check of the returned values does not."""
    res = drive(tree, "ppo.eval4096_1d", seconds=1.0, patch=RETURNED_FAULTS[fault])
    c = res["checks"]
    assert res["correct"] is False
    assert c["lanes_off"]["value"] <= c["lanes_off"]["limit"]
    assert c["bg_gap_median"]["value"] <= c["bg_gap_median"]["limit"]
    assert c["stats_off"]["value"] > c["stats_off"]["limit"]


def test_the_evaluation_cell_reads_the_cards_idle_share_and_copies():
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    assert {m["name"] for m in run.metrics_of(bench, "ppo.eval4096_1d", True)} == {
        "eval_host_ms.eval", "results_ms.eval", "k1b_roofline.eval", "d2h_ms.cohort",
        "device_idle.cohort"}


BASE_NS = 10 ** 12
OFF = 100.0  # trace us = span-clock us - BASE_NS / 1000 + OFF


def ns(us: float) -> int:
    return BASE_NS + int(round(us * 1000))


def env_steps():
    """Two steps of 1000 us: the eager issue (3 launches inside, one
    outside by the agent) and a 50-us fetch; the card busy 200 us a step."""
    out, marks, ev = [], [], []
    for k in range(2):
        b = k * 2000.0
        top = len(out)
        out += [Span("env.step", ns(b), ns(b + 1000), -1, k, {"lanes": 32, "ended": k}),
                Span("env.advance", ns(b + 10), ns(b + 900), top, k, {}),
                Span("env.fetch", ns(b + 900), ns(b + 950), top, k, {"bytes": 1408})]
        marks.append((ns(b), ns(b + 2)))
        t = b + OFF
        ev += [Event("cudaStreamQuery", HOST, t + 0.5, t + 1.5),
               Event("cudaLaunchKernel", HOST, t + 100, t + 103),
               Event("cudaLaunchKernel", HOST, t + 200, t + 203),
               Event("cuLaunchKernel", HOST, t + 300, t + 303),
               Event("cudaLaunchKernel", HOST, t + 1500, t + 1503),  # the agent's
               Event("elementwise_kernel", KERNEL, t + 100, t + 250),
               Event("Memcpy DtoH (Device -> Pinned)", COPY, t + 910, t + 960)]
    return {"spans": out, "anchors": marks, "events": ev, "trace_window_us": (OFF, 4000.0 + OFF),
            "calls": 2, "untraced": {"calls": 4, "window_s": 0.008}}


def evaluations():
    out = []
    for k, (whole, results) in enumerate(((20.0, 12.0), (30.0, 16.0))):
        b = k * 100_000.0
        top = len(out)
        out += [Span("evaluate", ns(b), ns(b + whole * 1000), -1, k, {}),
                Span("cohort.prepare", ns(b + 10), ns(b + 500), top, k, {}),
                Span("evaluate.results", ns(b + 2000), ns(b + 2000 + results * 1000), top, k, {})]
    ev = [Event("rollout_nn_kernel", KERNEL, 0.0, 4000.0)]
    return {"spans": out, "anchors": [], "events": ev, "trace_window_us": (0.0, 5000.0),
            "workload": {"batch": 4096, "hours": 24}, "config": {"hidden": 64, "sample_time": 3}}


READ = {
    "step_host_ms.env": (env_steps, 1.0),
    "fetch_ms.env": (env_steps, 0.05),
    "launches.env": (env_steps, 3.0),
    "device_idle.env": (env_steps, 100.0 * (1.0 - 200e-6 * 4 / 0.008)),
    "eval_host_ms.eval": (evaluations, 25.0),
    "results_ms.eval": (evaluations, 14.0),
}


@pytest.mark.parametrize("name", sorted(READ))
def test_the_new_readers(name):
    make, want = READ[name]
    got = run.load_module("metrics", name).read(make())
    assert got == pytest.approx(want, rel=1e-9)


def test_k1b_roofline_in_evaluation_reads_the_evaluation_count():
    from benchmark.counts import k1b
    from benchmark.harness import peaks

    got = run.load_module("metrics", "k1b_roofline.eval").read(evaluations())
    want = 100.0 * peaks.bound_s(**k1b.count(4096, 480, 64, 3, emit_learner_rows=False)) / 4e-3
    assert got == pytest.approx(want, rel=1e-12) and 0.0 < got < 100.0


@pytest.mark.parametrize("name", sorted(set(READ) - {"device_idle.env"}) + ["k1b_roofline.eval"])
def test_the_new_readers_read_nothing_without_spans(name):
    """A program without the spans (the parent), or a trace without K1b:
    nothing to read, and no raise."""
    rec = dict(evaluations(), spans=[], anchors=[], events=[])
    assert run.load_module("metrics", name).read(rec) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_bfloat16_control_fails_the_limits(cell):
    """The reference in bfloat16 in the program's place (``control``, what
    ``calibrate.py`` reads) leaves every limit of the cell."""
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    _, wl, conf = run.cell_files(cell, bench)
    wl = dict(wl, **TINY[cell])
    if cell.startswith("ppo."):
        conf = dict(conf, hidden=16)
    got = run.load_module("drivers", wl["entry"]).control(conf, wl, 2 ** 35 + 1)
    assert set(got) == CHECKS[cell]
    for name, limit in wl["limits"].items():
        assert got[name] > limit, name
