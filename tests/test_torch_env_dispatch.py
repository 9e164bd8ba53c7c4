"""How simulate_cohort routes a config to its two engines, as the JAX
engine routes to its own: 'auto' and 'pallas' run the rollout kernel K1a
for BB/PID float32 configs at one substep, 'auto' and 'xla' run the eager
env path for every other config, 'pallas' refuses those with ValueError,
``compat_mode`` needs its seeds; custom controllers see the cohort as [B]
tensors; a reference-style reward runs in the step.  (That the new entry
points raise without CUDA unless the CPU is asked for is
tests/test_torch_repairs.py's.)"""
import importlib
from datetime import timedelta

import numpy as np
import pytest
import torch

from simglucose_tpu_torch.analysis.risk import risk_scalar
from simglucose_tpu_torch.controllers import functional as tctl
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.envs.functional import rewards_from_cgm
from simglucose_tpu_torch.params import load_quest_params
from simglucose_tpu_torch.sim import engine

# the envs package exports a function of that name
env_rollout = importlib.import_module("simglucose_tpu_torch.envs.rollout")

torch.set_num_threads(1)

NAMES = ["adolescent#001", "adult#005", "child#003"]
HOUR = dict(sim_time=timedelta(hours=1), patient_names=NAMES, device="cpu", cgm_seed=2, scenario_seed=3)


@pytest.fixture
def calls(monkeypatch):
    """Counts of kernel calls and eager env steps made by the engine."""
    seen = {"kernel": 0, "eager": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(engine, "rollout", spy("kernel", engine.rollout))
    monkeypatch.setattr(env_rollout, "env_step", spy("eager", env_rollout.env_step))
    return seen


@pytest.mark.parametrize("engine_name", ["auto", "pallas"])
@pytest.mark.parametrize("controller", [None, "BB", "PID", ("PID", dict(P=-2e-4)), ("BB", dict(target=120.0))])
def test_eligible_configs_run_the_kernel(calls, engine_name, controller):
    res = engine.simulate_cohort(controller=controller, engine=engine_name, **HOUR)
    assert calls == {"kernel": 1, "eager": 0}
    assert res.traj.BG.shape == (20, 3) and res.traj.BG.dtype == np.float32


@pytest.mark.parametrize(
    "kw",
    [
        dict(engine="xla"),
        dict(dtype=np.float64),
        dict(dtype=torch.float64),
        dict(substeps=2),
        dict(controller=("BB", dict(P=1.0))),
        dict(controller=tctl.constant_controller(0.01, device="cpu")),
    ],
    ids=["xla", "f64", "torch-f64", "substeps", "bb-with-pid-kwargs", "custom"],
)
def test_other_configs_run_the_eager_path(calls, kw):
    if kw.get("controller", (None,))[0] == "BB":
        # JAX's general path passes the kwargs to bb_policy, which refuses them
        with pytest.raises(TypeError):
            engine.simulate_cohort(**HOUR, **kw)
        return
    res = engine.simulate_cohort(**HOUR, **kw)
    assert calls == {"kernel": 0, "eager": 20}
    assert res.traj.BG.shape == (20, 3) and np.isfinite(res.traj.BG).all()
    want = np.float64 if kw.get("dtype") in (np.float64, torch.float64) else np.float32
    assert res.traj.BG.dtype == want and res.reset.BG.dtype == want


@pytest.mark.parametrize(
    "kw,reason",
    [
        (dict(controller=tctl.constant_controller(0.01, device="cpu")), "a custom controller"),
        (dict(dtype=np.float64), "dtype="),
        (dict(substeps=4), "substeps=4"),
        (dict(scenario=[("x", 1)]), "an unparseable custom scenario"),
    ],
)
def test_pallas_refuses_what_the_kernel_cannot_run(calls, kw, reason):
    with pytest.raises(ValueError, match=rf"engine='pallas' cannot run this config \({reason}"):
        engine.simulate_cohort(engine="pallas", **HOUR, **kw)
    assert calls == {"kernel": 0, "eager": 0}


def test_compat_mode_checks_and_forces_the_eager_path(calls):
    hour = {k: v for k, v in HOUR.items() if k not in ("cgm_seed", "scenario_seed")}
    with pytest.raises(ValueError, match="explicit cgm_seed"):
        engine.simulate_cohort(compat_mode=True, scenario_seed=1, **hour)
    with pytest.raises(ValueError, match="requires scenario_seed"):
        engine.simulate_cohort(compat_mode=True, cgm_seed=1, **hour)
    with pytest.raises(ValueError, match="requires the XLA engine"):
        engine.simulate_cohort(compat_mode=True, cgm_seed=1, scenario_seed=1, engine="pallas", **hour)
    # a custom scenario needs no scenario seed
    res = engine.simulate_cohort(compat_mode=True, cgm_seed=1, scenario=[(0.5, 40)], **hour)
    assert calls == {"kernel": 0, "eager": 20}
    assert res.traj.BG.dtype == np.float64
    np.testing.assert_allclose(res.traj.CHO.sum(axis=0) * 3, 40.0)  # each patient ate the meal
    with pytest.raises(ValueError, match="engine must be"):
        engine.simulate_cohort(engine="jax", **HOUR)
    with pytest.raises(NotImplementedError, match="item 12"):
        engine.simulate_cohort(animate=True, **HOUR)


def test_custom_controllers_are_batch_native():
    """An (init, fn) pair gets [B] results and a shared state; it equals the
    built-in 'PID' when it is PID.  An (init, fn, in_axes) triple keeps a
    per-patient state; it equals 'BB' when it is BB."""
    shapes = []
    init, pid = tctl.pid_controller(3, P=-2e-4, I=-1e-7, D=-1e-3, device="cpu")

    def spy(state, result):
        shapes.append((tuple(result.observation.CGM.shape), tuple(state.integrated.shape)))
        return pid(state, result)

    got = engine.simulate_cohort(controller=(init, spy), engine="xla", **HOUR)
    ref = engine.simulate_cohort(controller=("PID", dict(P=-2e-4, I=-1e-7, D=-1e-3)), engine="xla", **HOUR)
    assert shapes[0] == ((3,), (3,)) and len(shapes) == 20
    np.testing.assert_array_equal(got.traj.insulin, ref.traj.insulin)
    np.testing.assert_array_equal(got.traj.BG, ref.traj.BG)

    cfg, params = make_env(NAMES, batch=True, device="cpu")
    bb = tctl.bb_params(params.patient, load_quest_params(NAMES, device="cpu"))
    got = engine.simulate_cohort(controller=(bb, tctl.bb_policy(3), 0), **HOUR)
    ref = engine.simulate_cohort(controller="BB", engine="xla", **HOUR)
    np.testing.assert_array_equal(got.traj.BG, ref.traj.BG)
    with pytest.raises(ValueError, match="controller must be"):
        engine.simulate_cohort(controller="MPC", **HOUR)


def test_reference_style_reward_runs_in_the_step():
    """A 1-argument reward over the last hour's history: the eager path
    computes it in every step with each lane's own window length, and it
    equals the replay the kernel path uses on the same CGM."""

    def span(hist):
        return -(hist[-1] - hist[0]) / len(hist)

    res = engine.simulate_cohort(reward_fun=span, engine="xla", **dict(HOUR, sim_time=timedelta(hours=2)))
    ref = rewards_from_cgm(span, 20, torch.from_numpy(res.reset.CGM), torch.from_numpy(res.traj.CGM))
    np.testing.assert_allclose(res.reward, ref.numpy(), rtol=1e-6, atol=1e-6)
    native = engine.simulate_cohort(engine="xla", **HOUR)
    _, _, r = risk_scalar(torch.from_numpy(native.traj.CGM))
    np.testing.assert_allclose(native.reward[1:], (r[:-1] - r[1:]).numpy(), rtol=1e-5, atol=1e-4)
