"""env_reset / env_step of the port against the JAX package's, stepped from
the same JAX state.

The JAX env path resets a cohort of B = 8 and runs 12 steps; the port takes
that mid-episode EnvState through ``from_jax`` (with its own Philox key
in place of the threefry keys) and both step it on for 24 steps with the
BB controller, in the exogenous-noise mode (the reference's MT19937 noise)
with each scenario mode: exogenous meals, a custom scenario, the random
scenario's plan carried over (a start at 06:00, no midnight in the run, so
no redraw is used) and none.  The port's own reset is held against JAX's
in the exogenous modes, where nothing is drawn.

Tolerances: float64 (rk45, 2 substeps) rtol 1e-12; float32 (rk4, 1
substep) those of tests/test_torch_rollout_exo.py: BG/CGM rtol 2e-6,
insulin rtol 1e-6 or one pump increment on at most 1% of the doses,
reward atol 1e-4, and CHO to 2 ulps (XLA may multiply by 1/sample_time
where the port keeps the IEEE division; tests/test_env_golden.py:9-14)."""
import dataclasses
from datetime import datetime

import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.compat.noise import reference_cgm_noise
from simglucose_tpu.compat.scenario import reference_meal_seq
from simglucose_tpu.controllers.functional import bb_params, bb_policy
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.functional import env_step as j_env_step
from simglucose_tpu.envs.rollout import batch_reset
from simglucose_tpu.params import load_quest_params, sensor_record
from simglucose_tpu_torch.controllers import functional as tctl
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.envs import functional as tenv
from simglucose_tpu_torch.ops.streams import env_keys

torch.set_num_threads(1)

B = 8
WARM, STEPS = 12, 24
CUSTOM = (np.array([40, 41, 75, 100], np.int32), np.array([30.0, 10.0, 55.0, 20.0]))
INC = 0.05 / 6000.0  # one pump increment, U/min


def check_insulin(got, ref):
    """Insulin rtol 1e-6, except on at most 1% of the doses, which may sit
    exactly one pump increment apart (a quantization flip of a command an
    ulp from a rounding boundary)."""
    got, ref = np.asarray(got), np.asarray(ref)
    off = ~np.isclose(got, ref, rtol=1e-6, atol=0.0)
    assert off.mean() <= 0.01, off.mean()
    if off.any():
        ulp = np.spacing(np.abs(ref[off]).max())
        np.testing.assert_allclose(np.abs(got - ref)[off], INC, rtol=0, atol=2 * ulp)


def check_results(got, ref, dtype, fields=("BG", "CGM", "CHO", "insulin", "reward", "done", "risk")):
    """A port StepResult (tensors) against a JAX one (arrays), same layout."""
    f64 = dtype == np.float64
    for f in fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if f in ("done",):
            np.testing.assert_array_equal(g, r, err_msg=f)
        elif f == "CHO":
            # to an ulp: XLA may multiply by 1/sample_time where the port
            # divides (tests/test_env_golden.py:9-14)
            np.testing.assert_allclose(g, r, rtol=1e-12 if f64 else 2.4e-7, atol=0, err_msg=f)
        elif f == "insulin":
            if f64:
                np.testing.assert_allclose(g, r, rtol=1e-12, err_msg=f)
            else:
                check_insulin(g, r)
        elif f == "reward":
            np.testing.assert_allclose(g, r, rtol=1e-12 if f64 else 0, atol=1e-12 if f64 else 1e-4,
                                       err_msg=f)
        elif f in ("risk", "LBGI", "HBGI"):
            np.testing.assert_allclose(g, r, rtol=1e-10 if f64 else 2e-5, atol=1e-10 if f64 else 1e-4,
                                       err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-12 if f64 else 2e-6, err_msg=f)


def jax_env(dtype, mode, substeps, method):
    """(cfg, params, bb params) of the JAX env for a scenario mode, with the
    reference's noise."""
    names = cohort_names(B)
    n = (WARM + STEPS) * 3
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, WARM + STEPS + 4)
    kw = dict(noise_seq=noise, substeps=substeps, method=method)
    if mode == "exogenous":
        # the reference's meal stream from 60 minutes before its first meal
        day = reference_meal_seq(1, datetime(2018, 1, 1), 1440)
        first = int(np.flatnonzero(day)[0])
        kw["meal_seq"] = day[first - 60:first - 60 + n + 3]
    elif mode == "custom":
        kw.update(custom_times=CUSTOM[0], custom_amounts=CUSTOM[1], scenario_mode="custom")
    else:
        kw["scenario_mode"] = mode
    cfg, params = make_env(names, batch=True, dtype=dtype, **kw)
    quest = load_quest_params(names, dtype=dtype)
    return cfg, params, bb_params(params.patient, quest)


def port_env(cfg, params):
    tcfg = tenv.EnvConfig(**dataclasses.asdict(cfg))
    return tcfg, from_jax(params, device="cpu")


def _start(mode):
    return 6 * 60 if mode == "random" else 0


CASES = [(np.float64, 2, "rk45"), (np.float32, 1, "rk4")]


@pytest.mark.parametrize("dtype,substeps,method", CASES, ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["exogenous", "custom", "random", "none"])
def test_env_step_continues_a_jax_state(dtype, substeps, method, mode):
    cfg, params, bb = jax_env(dtype, mode, substeps, method)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=_start(mode))

    @jax.jit
    def jstep(bb, state, res):
        bb, action = jax.vmap(bb_policy(3))(bb, res)
        return (bb,) + jax.vmap(lambda p, s, a: j_env_step(cfg, p, s, a))(params, state, action)

    for _ in range(WARM):
        bb, state, res = jstep(bb, state, res)

    tcfg, tparams = port_env(cfg, params)
    tkey = env_keys(0, B, device="cpu")
    tstate, tres = from_jax(state, device="cpu", key=tkey), from_jax(res, device="cpu")
    tbb = from_jax(bb, device="cpu")
    policy = tctl.bb_policy(3)
    cho = 0.0
    for t in range(STEPS):
        bb, state, res = jstep(bb, state, res)
        tbb, taction = policy(tbb, tres)
        tstate, tres = tenv.env_step(tcfg, tparams, tstate, taction)
        check_results(tres, res, dtype)
        cho += float(tres.CHO.sum())
    tol = dict(rtol=1e-12) if dtype == np.float64 else dict(rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(tstate.patient.x[:, 12].numpy(), np.asarray(state.patient.x[:, 12]), **tol)
    np.testing.assert_allclose(tstate.cgm_window.numpy(), np.asarray(state.cgm_window), rtol=tol["rtol"])
    for f in ("t",):
        np.testing.assert_array_equal(getattr(tstate.patient, f).numpy(), np.asarray(getattr(state.patient, f)))
    np.testing.assert_array_equal(tstate.sensor.sample_count.numpy(), np.asarray(state.sensor.sample_count))
    np.testing.assert_array_equal(tstate.window_len.numpy(), np.asarray(state.window_len))
    np.testing.assert_array_equal(tstate.episode_step.numpy(), np.asarray(state.episode_step))
    if mode in ("exogenous", "custom"):
        assert cho > 0  # meals were eaten in the compared steps


@pytest.mark.parametrize("dtype,substeps,method", CASES, ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["exogenous", "custom"])
def test_env_reset_matches_jax(dtype, substeps, method, mode):
    """The reset result and state where nothing is drawn: x0 init, the
    reference noise's first two pops, the window holding the first."""
    cfg, params, _ = jax_env(dtype, mode, substeps, method)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    tcfg, tparams = port_env(cfg, params)
    tstate, tres = tenv.env_reset(tcfg, tparams, env_keys(0, B, device="cpu"), start_min=0)
    check_results(tres, res, dtype, fields=("BG", "CGM", "CHO", "insulin", "reward", "done", "risk",
                                            "LBGI", "HBGI"))
    np.testing.assert_allclose(tres.observation.CGM.numpy(), np.asarray(res.observation.CGM), rtol=1e-12)
    for f in ("x", "last_Qsto", "planned_meal", "t", "is_eating"):
        np.testing.assert_array_equal(getattr(tstate.patient, f).numpy(), np.asarray(getattr(state.patient, f)))
    np.testing.assert_array_equal(tstate.cgm_window.numpy(), np.asarray(state.cgm_window))
    np.testing.assert_array_equal(tstate.sensor.sample_count.numpy(), np.asarray(state.sensor.sample_count))
    assert tstate.key.shape == (B, 4) and tstate.sensor.key is tstate.key


def test_modes_are_checked():
    cfg, params, _ = jax_env(np.float64, "none", 1, "rk4")
    tcfg, tparams = port_env(cfg, params)
    key = env_keys(0, B, device="cpu")
    with pytest.raises(ValueError, match="noise_mode='native' but EnvParams.noise_seq"):
        tenv.env_reset(dataclasses.replace(tcfg, noise_mode="native"), tparams, key)
    with pytest.raises(ValueError, match="requires EnvParams.noise_seq"):
        tenv.env_reset(tcfg, tparams._replace(noise_seq=None), key)
    with pytest.raises(ValueError, match="not ported"):
        tenv.env_reset(dataclasses.replace(tcfg, noise_mode="xs"), tparams, key)
    state, res = tenv.env_reset(tcfg, tparams, key)
    with pytest.raises(ValueError, match="unknown scenario_mode"):
        tenv.env_step(dataclasses.replace(tcfg, scenario_mode="xs"), tparams, state,
                      tctl.constant_controller(0.01, dtype=torch.float64, device="cpu")[1]((), res)[1])
