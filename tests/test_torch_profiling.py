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


# ---------------------------------------------------------------------------
# Spans: the recorder, the shared clock, the span tree of the program's paths
# ---------------------------------------------------------------------------


@pytest.fixture
def record():
    """An empty span record, emptied again after the test."""
    tprof.clear_spans()
    yield tprof
    tprof.clear_spans()


@tprof.span("test.decorated")
def _decorated(x):
    tprof.count("items", x)
    return x + 1


def _cpu_session():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("use", ["with", "decorator", "count"])
def test_spans_off_record_nothing(record, use):
    """No profiler session: span() is the name's one shared null object,
    and nothing reaches the record."""
    assert tprof.span("a") is tprof.span("a") and tprof.span("a") is not tprof.span("b")
    if use == "with":
        with tprof.span("a") as s:
            tprof.count("n")
        assert s is tprof.span("a")
    elif use == "decorator":
        assert _decorated(2) == 3 and _decorated.__name__ == "_decorated"
    else:
        tprof.count("n", 5)
    assert tprof.spans() == [] and tprof.anchors() == [] and tprof.dropped() == 0


def test_spans_nest_under_a_session(record):
    """Parents, call ids, counters on the innermost span, one anchor a
    top-level span; the session's end turns spans off again."""
    with _cpu_session():
        for _ in range(2):
            with tprof.span("top"):
                tprof.count("hits")
                with tprof.span("mid"):
                    assert _decorated(4) == 5
                    tprof.count("hits", 2)
                with tprof.span("leaf"):
                    pass
    with tprof.span("after"):
        pass
    got = tprof.spans()
    assert [(s.name, s.parent, s.call) for s in got] == [
        ("top", -1, 0), ("mid", 0, 0), ("test.decorated", 1, 0), ("leaf", 0, 0),
        ("top", -1, 1), ("mid", 4, 1), ("test.decorated", 5, 1), ("leaf", 4, 1)]
    assert got[0].counts == {"hits": 1} and got[1].counts == {"hits": 2}
    assert got[2].counts == {"items": 4} and got[3].counts == {}
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    marks = tprof.anchors()
    assert len(marks) == 2 and all(got[4 * k].start_ns <= a <= b <= got[4 * k + 1].start_ns
                                   for k, (a, b) in enumerate(marks))


def test_span_record_is_capped(record, monkeypatch):
    monkeypatch.setattr(tprof, "MAX_SPANS", 3)
    with _cpu_session():
        for _ in range(3):
            with tprof.span("top"):
                with tprof.span("child"):
                    pass
    assert [s.name for s in tprof.spans()] == ["top", "child", "top"]
    assert tprof.dropped() == 3 and len(tprof.anchors()) == 2


@pytest.mark.parametrize("offset_us", [-32962342.25, 0.0, 1.5e9])
def test_trace_offset_recovers_a_planted_offset(offset_us):
    """Anchors 2 ms apart, each a 2-us bracket around a 1-us event on a
    clock ``offset_us`` ahead; the first has a 1.4-ms bracket whose event
    sits at its end (a first call's set-up inside the bracket)."""
    marks, events = [], [("cudaLaunchKernel", 5.0, 9.0)]
    for k in range(9):
        t0 = 1_000_000_000 + k * 2_000_000
        t1 = t0 + (1_400_000 if k == 0 else 2_000)
        marks.append((t0, t1))
        e_end = t1 * 1e-3 + offset_us - 0.5
        events.append(("cudaStreamQuery", e_end - 1.0, e_end))
    off, spread = tprof.trace_offset_us(reversed(events), marks)
    assert abs(off - offset_us) < 1.0 and spread == 0.0
    bad = list(marks)
    bad[4] = (bad[4][0] + 50_000, bad[4][1] + 50_000)  # 50 us off its event
    assert tprof.trace_offset_us(events, bad)[1] == pytest.approx(50.0 - 1.0, abs=1.0)
    assert tprof.trace_offset_us(events, marks[:-1]) is None
    assert tprof.trace_offset_us(events[:1], []) is None


def test_span_table_self_and_idle():
    """Self time leaves out the children; the card's idle time under a span
    and while it was the innermost, from busy intervals on the trace's
    clock (offset 100 us)."""
    S = tprof.Span
    got = [S("top", 0, 10_000, -1, 0, {"n": 1}), S("kid", 2_000, 6_000, 0, 0, {}),
           S("top", 20_000, 21_000, -1, 1, {"n": 2})]
    busy = tprof.Busy([(103.0, 104.0), (103.5, 105.0), (108.0, 130.0)])
    assert busy.covered(100.0, 110.0) == pytest.approx(4.0)
    t = tprof.span_table(got, busy, 100.0)
    assert t["top"]["calls"] == 2 and t["top"]["counts"] == {"n": 3}
    assert t["top"]["total_ms"] == pytest.approx(0.011)
    assert t["top"]["self_ms"] == pytest.approx(0.007)
    assert t["top"]["idle_ms"] == pytest.approx(0.006)  # 10 - 4 us, then 0
    assert t["kid"]["idle_ms"] == pytest.approx(0.002)  # 102-106: 2 us busy
    assert t["top"]["idle_self_ms"] == pytest.approx(0.004)
    assert tprof.span_table(got)["top"]["idle_ms"] is None


def test_device_trace_writes_the_spans(tmp_path, record):
    a = torch.randn(256, 256)
    with tprof.device_trace(str(tmp_path)):
        for _ in range(3):
            with tprof.span("step"):
                with tprof.span("step.mm"):
                    (a @ a).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in track] == ["step", "step.mm"] * 3
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 3
    for op, s in zip(mm, track[1::2]):  # each aten::mm inside its span on the trace's clock
        assert s["ts"] <= op["ts"] + 0.5 * op["dur"] <= s["ts"] + s["dur"]
    with open(tmp_path / "spans.json") as f:
        table = json.load(f)
    assert table["clock"]["spread_us"] < 1000.0 and table["dropped"] == 0
    assert table["spans"]["step"]["calls"] == 3 and table["spans"]["step.mm"]["calls"] == 3
    assert 0.0 <= table["spans"]["step"]["self_ms"] < table["spans"]["step"]["total_ms"]
    assert table["spans"]["step"]["idle_ms"] is None  # no card activity in a CPU trace


# the span trees of the program's paths, as (span, enclosing span); on the
# CPU the rollout runs its plain version, so no "rollout.launch"
FUSED_TREE = {("fused.iteration", None), ("fused.rollout", "fused.iteration"),
              ("rollout", "fused.rollout"), ("gae", "fused.iteration"),
              ("fused.learner", "fused.iteration"), ("learner.minibatch", "fused.learner"),
              ("grad_step", "learner.minibatch"), ("learner.adam", "learner.minibatch")}
COHORT_TREE = {("simulate", None), ("simulate_cohort", "simulate"), ("cohort.frame", "simulate"),
               ("cohort.prepare", "simulate_cohort"), ("rollout", "simulate_cohort"),
               ("cohort.finish", "simulate_cohort"), ("cohort.fetch", "simulate_cohort")}


def _fused_run():
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.rl import policy as tpol
    from simglucose_tpu_torch.rl import ppo as tppo
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_step

    B, H = 128, 8
    cfg = tppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2, pallas_learner=True)
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    packed = tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))
    g = torch.Generator().manual_seed(3)
    pol = tpol.init_policy(g, hidden=H, act="relu", init_mu_bias=-2.2, device="cpu")
    ts = init_fused_state(pol, tppo.make_optimizer(cfg).init(pol), B, g)
    ts, m = make_fused_train_step(cfg, B, hidden=H)(packed, ts)
    return [*ts.params.leaves(), ts.opt_state.mu, ts.state_f, ts.state_i, *m.values()]


def _cohort_run():
    from datetime import timedelta

    from simglucose_tpu_torch.sim.engine import simulate

    df = simulate(sim_time=timedelta(minutes=30), patient_names=["adolescent#001", "adult#002"],
                  scenario_seed=4, cgm_seed=5, device="cpu")
    return [torch.from_numpy(df.select_dtypes("number").to_numpy().copy()),
            torch.from_numpy(df.attrs["reward"].copy())]


@pytest.mark.parametrize("path, run, tree, counts", [
    ("fused", _fused_run, FUSED_TREE, {"learner.minibatch": 4, "grad_step": 4, "rollout": 1}),
    ("cohort", _cohort_run, COHORT_TREE, {"simulate_cohort": 1, "rollout": 1, "cohort.frame": 1}),
])
def test_spans_leave_the_outputs_bit_equal_and_name_the_tree(record, path, run, tree, counts):
    off = run()
    assert tprof.spans() == []
    with _cpu_session():
        on = run()
    for a, b in zip(off, on):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path
    got = tprof.spans()
    assert {(s.name, got[s.parent].name if s.parent >= 0 else None) for s in got} == tree
    assert len({s.call for s in got}) == 1 and len(tprof.anchors()) == 1
    for name, n in counts.items():
        assert sum(s.name == name for s in got) == n, name


def test_the_kernel_launch_has_its_span(record, monkeypatch):
    """``rollout.launch`` wraps the library call in ``_rollout_cuda``,
    driven here with a stand-in library and stream."""
    import types

    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import rollout as tr

    calls = []
    lib = types.SimpleNamespace(sgt_rollout_launch=lambda *a: calls.append(
        [s.name for s in tprof.spans() if s.end_ns == 0]) or 0)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    cfg = tr.config_for_sensor("Dexcom", controller="pid", n_steps=2)
    packed = torch.zeros(tr.NP_PLANES, 1, tr.LANES)
    with _cpu_session():
        with tprof.span("rollout"):
            tr._rollout_cuda(cfg, packed, (1, 2), None, None, None, 1, 0, None, 0)
    assert calls == [["rollout", "rollout.launch"]]
    assert [s.name for s in tprof.spans()] == ["rollout", "rollout.launch"]
