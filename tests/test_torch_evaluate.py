"""Policy and therapy evaluation of the port against the JAX package's.

``simglucose_tpu_torch/rl/evaluate.py`` against ``simglucose_tpu/rl/
evaluate.py``: the clinical statistics on one seeded BG matrix (rtol 1e-6;
torch's and XLA's CPU log/pow round their last bits differently), the
rollout config each builds for a policy evaluation (field for field, both
shipped checkpoints), determinism, the pairing of a policy with a therapy
at one seed (identical meal scenarios and initial states), and the gates of
``tests/test_ppo_eval.py`` with its margins, run through the plain versions
on the CPU: the relu-64 checkpoint against PID (30 patients x 6 h) and the
residual-BB checkpoint against BB (30 patients x 24 h), both at seed 1234."""
import dataclasses
import os
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.rl import evaluate as jev
from simglucose_tpu.rl.policy import init_policy as jinit_policy
from simglucose_tpu.utils.checkpoint import restore_state
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.core.types import CtrlAction
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import evaluate as ev
from simglucose_tpu_torch.rl import policy as pol
from simglucose_tpu_torch.sim import engine

torch.set_num_threads(1)

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "checkpoints")
# (file, decoder metadata the checkpoint was trained with): tests/test_ppo_eval.py
CKPTS = {
    "relu64": ("ppo_cohort_relu64.npz", dict(act="relu", action_scale=10.0, scale_by_basal=True)),
    "residual_bb": ("ppo_cohort_residual_bb.npz",
                    dict(act="relu", action_scale=1.1, scale_by_basal=False, decoder="residual_bb")),
}
SEED = 1234


def _port_policy(which):
    path, meta = CKPTS[which]
    return pol.load_policy_npz(os.path.join(CKPT_DIR, path), device="cpu", **meta)


def _jax_policy(which):
    path, meta = CKPTS[which]
    like = jinit_policy(jax.random.PRNGKey(0), hidden=64, **meta)
    return restore_state(os.path.join(CKPT_DIR, path), like=like)


def _mean(res, key):
    return float(res[key].mean())


def test_cohort_stats_match_the_jax_package():
    rng = np.random.default_rng(3)
    bg = np.clip(140 + np.cumsum(rng.normal(0, 12, (6, 300)), axis=1), 20, 450).astype(np.float32)
    assert (bg < 50).any() and (bg > 250).any()
    want = jev.cohort_stats(bg)
    got = ev.cohort_stats(bg)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).shape == (6,), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


def _zero_traj(T, B):
    out = {k: torch.zeros(T, B) for k in ("BG", "CGM", "CHO", "insulin")}
    out.update(BG0=torch.zeros(B), CGM0=torch.zeros(B), state_f=None, state_i=None)
    return out


@pytest.mark.parametrize("which", list(CKPTS))
def test_policy_config_matches_the_jax_package(monkeypatch, which):
    """The config the port's evaluate_policy_kernel runs, field by field
    against the one the JAX function hands its kernel (both captured by
    stubs that return zero planes)."""
    from simglucose_tpu.ops import pallas_rollout as jpr

    seen = {}

    def jax_stub(cfg, padded, interpret=False):
        seen["jax"] = (cfg, padded)
        return lambda packed, seed, weights=None: {
            k: np.zeros((cfg.n_steps, padded), np.float32) for k in ("BG", "CGM", "insulin")}

    def port_stub(cfg, packed, seed=0, weights=None, **kw):
        seen["port"] = (cfg, packed.numel() // tr.NP_PLANES, seed, weights)
        return _zero_traj(cfg.n_steps, packed.numel() // tr.NP_PLANES)

    monkeypatch.setattr(jpr, "make_pallas_rollout", jax_stub)
    monkeypatch.setattr(engine, "rollout", port_stub)
    names = tables.patient_names()
    jev.evaluate_policy_kernel(_jax_policy(which), names, hours=24.0, seed=5, start_min=60,
                               shard=False)
    out = ev.evaluate_policy_kernel(_port_policy(which), names, hours=24.0, seed=5, start_min=60,
                                    device="cpu")
    jcfg, jpadded = seen["jax"]
    cfg, padded, seed, weights = seen["port"]
    assert padded == jpadded == 128 and seed == 5
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.controller == "nn" and not cfg.nn_sample_actions and not cfg.autoreset
    assert cfg.n_steps == 480 and cfg.fixed_start_min == 60
    assert weights.shape == (64, 80)
    assert out["BG"].shape == (30, 480) and out["names"] == names


def test_policy_evaluation_is_deterministic():
    policy = _port_policy("relu64")
    names = ["adolescent#001", "adult#003", "child#007"]
    a, b = (ev.evaluate_policy_kernel(policy, names, hours=1.0, seed=3, device="cpu")
            for _ in range(2))
    assert a["BG"].shape == (3, 20) and np.isfinite(a["BG"]).all()
    np.testing.assert_array_equal(a["BG"], b["BG"])
    np.testing.assert_array_equal(a["insulin_mean"], b["insulin_mean"])
    assert set(a) >= {"percent_in_70_180", "LBGI", "HBGI", "risk_index", "names", "CGM"}


def test_policy_and_therapy_are_paired_at_one_seed(monkeypatch):
    """evaluate_policy_kernel and evaluate_controller('BB') at one seed
    launch rollouts with identical meal plans (the CHO planes) and initial
    states (BG0, CGM0); another seed changes both."""
    launched = []
    real = engine.rollout

    def recorder(*args, **kw):
        out = real(*args, **kw)
        launched.append(out)
        return out

    monkeypatch.setattr(engine, "rollout", recorder)
    policy = _port_policy("residual_bb")
    names = tables.patient_names()[:3]
    kw = dict(hours=6.0, start_min=360, random_init_bg=True, device="cpu")
    for seed in (11, 12):
        ev.evaluate_policy_kernel(policy, names, seed=seed, **kw)
        ev.evaluate_controller("BB", names, seed=seed, **kw)
    (pol11, bb11, pol12, bb12) = launched
    assert pol11["CHO"].sum() > 0
    for k in ("CHO", "BG0", "CGM0"):
        assert torch.equal(pol11[k], bb11[k]), k
        assert torch.equal(pol12[k], bb12[k]), k
    assert not torch.equal(pol11["CHO"], pol12["CHO"])
    assert not torch.equal(pol11["BG0"], pol12["BG0"])
    assert not torch.equal(pol11["insulin"], bb11["insulin"]), "the policy must act"


def test_residual_policy_doses_within_its_band():
    """tests/test_ppo_eval.py:205-237 on the port: over 4 steps without a
    meal the residual policy's mean insulin stays within the modulation
    band of the therapy basal."""
    names = ["adolescent#001", "adult#003", "child#007"]
    out = ev.evaluate_policy_kernel(_port_policy("residual_bb"), names, hours=4 * 3 / 60.0,
                                    seed=5, device="cpu")
    assert out["BG"].shape == (3, 4) and np.isfinite(out["BG"]).all()
    basal = basal_rate(tables.load_patient_params(names, device="cpu")).numpy()
    ratio = out["insulin_mean"] / basal
    assert (ratio > np.exp(-1.2)).all() and (ratio < np.exp(1.2) + 0.5).all()


def test_relu64_checkpoint_beats_pid():
    """tests/test_ppo_eval.py::test_ppo_checkpoint_beats_pid_baseline's
    gate: 30 patients x 6 h, seed 1234, paired."""
    names = tables.patient_names()
    ppo = ev.evaluate_policy_kernel(_port_policy("relu64"), names, hours=6.0, seed=SEED,
                                    device="cpu")
    pid = ev.evaluate_controller("PID", names, hours=6.0, seed=SEED, device="cpu")
    assert _mean(ppo, "risk_index") <= _mean(pid, "risk_index")
    assert _mean(ppo, "percent_below_50") < 1.0
    assert _mean(ppo, "percent_in_70_180") > 50.0
    assert np.isfinite(ppo["BG"]).all()


def test_residual_checkpoint_competes_with_bb():
    """tests/test_ppo_eval.py::test_residual_checkpoint_competes_with_bb's
    gate: 30 patients x 24 h, seed 1234, paired; RI <= 1.05 x BB, TIR >=
    BB - 2, hypo < 70 <= BB + 0.5."""
    names = tables.patient_names()
    ppo = ev.evaluate_policy_kernel(_port_policy("residual_bb"), names, hours=24.0, seed=SEED,
                                    device="cpu")
    bb = ev.evaluate_controller("BB", names, hours=24.0, seed=SEED, device="cpu")
    assert _mean(ppo, "risk_index") <= 1.05 * _mean(bb, "risk_index")
    assert _mean(ppo, "percent_in_70_180") >= _mean(bb, "percent_in_70_180") - 2.0
    assert _mean(ppo, "percent_below_70") <= _mean(bb, "percent_below_70") + 0.5
    assert np.isfinite(ppo["BG"]).all()


def test_therapy_evaluation_is_the_simulated_cohort():
    """evaluate_controller('BB') at seed s runs simulate_cohort's cohort:
    the same BG and CGM planes as its run keyed by (s, 0) with the
    evaluation's pump, bit for bit."""
    names = ["adolescent#001", "adult#003", "child#007"]
    got = ev.evaluate_controller("BB", names, hours=3.0, seed=7, device="cpu")
    want = engine.simulate_cohort(sim_time=timedelta(hours=3), controller="BB",
                                  patient_names=names, scenario_seed=7, cgm_seed=0,
                                  insulin_pump_name="Insulet", device="cpu")
    assert got["BG"].shape == (3, 60)
    np.testing.assert_array_equal(got["BG"], want.traj.BG.T)
    np.testing.assert_array_equal(got["CGM"], want.traj.CGM.T)


def test_custom_controller_raises():
    """What is not a controller raises (a bare function, an unknown name);
    an ``(init, fn)`` controller now runs, on the eager env path."""
    with pytest.raises(ValueError, match="controller"):
        ev.evaluate_controller(lambda state, obs: (state, 0.0), ["adult#001"], hours=1.0,
                               device="cpu")
    with pytest.raises(ValueError, match="controller"):
        ev.evaluate_controller("MPC", ["adult#001"], hours=1.0, device="cpu")
    zero = lambda s, r: (s, CtrlAction(basal=torch.zeros_like(r.CGM),
                                       bolus=torch.zeros_like(r.CGM)))
    res = ev.evaluate_controller(((), zero), ["adult#001"], hours=1.0, device="cpu")
    assert res["BG"].shape == (1, 20) and res["insulin_mean"][0] == 0.0


def test_therapy_config_is_the_simulate_config_over_the_whole_horizon():
    """evaluate_controller runs simulate()'s kernel config (the engine's
    public kernel_config) in one call, however long the horizon."""
    n = engine.MAX_STEPS_PER_CALL + 5
    cfg = ev.controller_config(("PID", dict(P=-2e-4)), "GuardianRT", n, start_min=90)
    assert cfg == engine.kernel_config("GuardianRT", ev.PUMP, ("PID", dict(P=-2e-4)), n, 90)
    assert cfg.n_steps == n and cfg.controller == "pid" and cfg.pid_p == -2e-4
    assert not cfg.autoreset and cfg.fixed_start_min == 90
    with pytest.raises(TypeError):
        engine.check_eligible("BB", False)  # the switches are keywords
    with pytest.raises(NotImplementedError, match="substeps"):
        engine.check_eligible("BB", substeps=2)


def test_stats_frame_has_the_jax_functions_columns():
    names = tables.patient_names()[:4]
    res = ev.evaluate_controller("BB", names, hours=2.0, seed=2, device="cpu")
    got, want = ev.stats_frame(res), jev.stats_frame(res)
    assert list(got.columns) == list(want.columns) and list(got.index) == names
    assert got.equals(want)
    assert "risk_index" in got.columns and "BG" not in got.columns
