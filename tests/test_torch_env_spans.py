"""The spans of the vector env (``env.reset``, ``env.step`` with its
``lanes`` and ``ended`` counters, ``env.advance``, ``env.fetch`` with its
``bytes``) and of evaluation (``evaluate``, ``evaluate.results``): recorded
under a profiler session, nothing recorded without one, and the outputs
bit-equal either way."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from simglucose_tpu_torch.envs.gym_env import T1DSimVectorEnv
from simglucose_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

B, STEPS, PLANES = 8, 30, 11  # 11 planes a step (envs/gym_env.py::_PLANES)


@pytest.fixture
def record():
    tprof.clear_spans()
    yield
    tprof.clear_spans()


def _cpu_session():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _drive():
    """A reset, 30 steps (the 72-minute horizon truncates every env at step
    24) and a ``step_n`` of 2; every output as arrays."""
    env = T1DSimVectorEnv(B, seed=5, device="cpu", horizon_days=0.05)
    out = list(env.reset(seed=11))
    for _ in range(STEPS):
        obs, reward, term, trunc, info = env.step(np.full((B, 1), 0.03, np.float32))
        out += [obs, reward, term, trunc, info["bg"], info["risk"], info["meal"], info["insulin"]]
    obs, reward, term, trunc, infos = env.step_n(2, lambda o: torch.full_like(o, 0.02))
    return out[:1] + out[2:] + [obs, reward, term, trunc, infos["bg"]], out


def test_env_spans_off_record_nothing_and_on_name_the_tree(record):
    off, _ = _drive()
    assert tprof.spans() == [] and tprof.anchors() == []
    with _cpu_session():
        on, raw = _drive()
    for a, b in zip(off, on):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    got = tprof.spans()
    tree = {(s.name, got[s.parent].name if s.parent >= 0 else None) for s in got}
    assert tree == {("env.reset", None), ("env.step", None), ("env.advance", "env.step"),
                    ("env.fetch", "env.step"), ("env.advance", None), ("env.fetch", None)}
    tops = [s for s in got if s.parent < 0]
    assert [s.name for s in tops] == ["env.reset"] + ["env.step"] * STEPS + [
        "env.advance", "env.advance", "env.fetch"]
    assert len(tprof.anchors()) == len(tops)
    ended = [int((raw[2 + 8 * t + 2] | raw[2 + 8 * t + 3]).sum()) for t in range(STEPS)]
    steps = [s for s in got if s.name == "env.step"]
    assert [s.counts for s in steps] == [{"lanes": B, "ended": n} for n in ended]
    assert sum(ended) >= B  # the horizon ended every env
    fetch = [s.counts for s in got if s.name == "env.fetch"]
    assert fetch == [{"bytes": PLANES * B * 4}] * STEPS + [{"bytes": 2 * PLANES * B * 4}]


def _evaluations(kind: str):
    from simglucose_tpu_torch.controllers.functional import bb_controller, bb_params
    from simglucose_tpu_torch.params import load_patient_params, load_quest_params
    from simglucose_tpu_torch.rl.evaluate import evaluate_controller, evaluate_policy_kernel
    from simglucose_tpu_torch.rl.policy import init_policy

    names = ["adolescent#001", "child#002"]
    if kind == "policy":
        params = init_policy(torch.Generator().manual_seed(3), hidden=8, act="relu",
                             init_mu_bias=-2.2, device="cpu")
        return evaluate_policy_kernel(params, names, hours=1.0, seed=4, device="cpu")
    if kind == "bb":
        return evaluate_controller("BB", names, hours=1.0, seed=4, device="cpu")
    p = load_patient_params(names, device="cpu")
    q = load_quest_params(names, device="cpu")
    init, fn = bb_controller(bb_params(p, q), 3)
    return evaluate_controller((init, fn), names, hours=1.0, seed=4, device="cpu")


@pytest.mark.parametrize("kind", ["policy", "bb", "eager"])
def test_evaluate_spans_open_around_each_evaluation(record, kind):
    off = _evaluations(kind)
    assert tprof.spans() == []
    with _cpu_session():
        on = _evaluations(kind)
    assert np.array_equal(off["BG"], on["BG"]) and np.array_equal(off["LBGI"], on["LBGI"])
    got = tprof.spans()
    tops = [s for s in got if s.parent < 0]
    assert [s.name for s in tops] == ["evaluate"]
    results = [s for s in got if s.name == "evaluate.results"]
    assert len(results) == 1 and got[results[0].parent].name == "evaluate"
