"""Port rollout K1a (plain PyTorch version) vs the JAX package: PID with the
state carried across calls (against the JAX kernel itself in interpret
mode), deterministic BB with meals and the other sensors (against the JAX
env path, the JAX kernel's own plain reference).

Tolerances are the JAX kernel's own (tests/test_pallas_rollout.py): BG/CGM
rtol 2e-6, insulin rtol 1e-6, CHO and done exact, reward atol 1e-4.  Both
sides are float32; they differ only in the order XLA and PyTorch round
transcendentals (tanh, log, pow) on the CPU."""
import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.controllers.functional import bb_params, bb_policy, pid_controller
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import batch_reset, broadcast_ctrl_state, make_batch_continue_fn
from simglucose_tpu.models.uva_padova import basal_rate as jax_basal_rate
from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu.params import load_quest_params
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr

torch.set_num_threads(1)

B = 128  # one lane row


def _packed(names, quest=None, sensor="Dexcom"):
    """(JAX EnvParams, JAX packed planes, port packed planes) for ``names``."""
    _, params = make_env(names, sensor=sensor, batch=True, dtype=np.float32)
    patient = from_jax(params.patient, device="cpu")
    packed_t = tr.pack_params(patient, basal_rate(patient), quest=None if quest is None else from_jax(quest, device="cpu"))
    packed_j = jpr.pack_params(params.patient, jax_basal_rate(params.patient), quest=quest)
    return params, packed_j, packed_t


def _env_traj(names, ctrl, cs, T, sensor="Dexcom", meal_seq=None, noise_seq=None):
    """The JAX env path's [T, B] trajectory (x0 init, start minute 0)."""
    cfg, params = make_env(
        names, sensor=sensor, batch=True, dtype=np.float32,
        scenario_mode="none" if meal_seq is None else "exogenous", meal_seq=meal_seq,
        noise_seq=np.zeros(T + 4, np.float32) if noise_seq is None else noise_seq,
        substeps=1, method="rk4",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    _, _, _, traj = make_batch_continue_fn(cfg, ctrl, T)(params, state, cs, res)
    return res, traj


def _assert_traj(got, ref, done=True):
    np.testing.assert_allclose(got["BG"].numpy(), np.asarray(ref.BG), rtol=2e-6)
    np.testing.assert_allclose(got["CGM"].numpy(), np.asarray(ref.CGM), rtol=2e-6)
    np.testing.assert_allclose(got["insulin"].numpy(), np.asarray(ref.insulin), rtol=1e-6)
    np.testing.assert_array_equal(got["CHO"].numpy(), np.asarray(ref.CHO))
    np.testing.assert_allclose(got["reward"].numpy(), np.asarray(ref.reward), atol=1e-4)
    if done:
        np.testing.assert_array_equal(got["done"].numpy(), np.asarray(ref.done))


# state planes the port carries (the JAX kernel's 41..60 and int 6 hold its
# cached reset draws, which the port does not keep)
_F_PLANES = list(range(41)) + [61, 62, 63]
_I_PLANES = list(range(6))


def test_deterministic_pid_state_carried_matches_jax_kernel():
    """Deterministic PID run as two calls threading the persistent state,
    against the JAX kernel in interpret mode: trajectories of both calls,
    the reset rows and the final state planes agree (BG/CGM rtol 2e-6,
    insulin rtol 1e-6, CHO/done exact, reward atol 1e-4; float state planes
    rtol 2e-6 with the floors below, int planes exact)."""
    names = cohort_names(B)
    _, packed_j, packed_t = _packed(names)
    T = 6
    jcfg = jpr.PallasRolloutConfig(
        n_steps=T, block_rows=1, t_chunk=3, deterministic=True, controller="pid",
        persistent_state=True,
    )
    run = jax.jit(jpr.make_pallas_rollout(jcfg, B, interpret=True))
    j0 = run(packed_j, 0, init=1)
    j1 = run(packed_j, 0, state=(j0["state_f"], j0["state_i"]), init=0)

    tcfg = tr.RolloutConfig(n_steps=T, deterministic=True, controller="pid")
    t0 = tr.rollout(tcfg, packed_t, 0)
    t1 = tr.rollout(tcfg, packed_t, 0, state=(t0["state_f"], t0["state_i"]), init=0, step_offset=T)

    for got, ref in ((t0, j0), (t1, j1)):
        for k, kw in (("BG", dict(rtol=2e-6)), ("CGM", dict(rtol=2e-6)),
                      ("insulin", dict(rtol=1e-6)), ("reward", dict(atol=1e-4))):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **kw)
        np.testing.assert_array_equal(got["CHO"].numpy(), np.asarray(ref["CHO"]))
        np.testing.assert_array_equal(got["done"].numpy(), np.asarray(ref["done"]))
        sf_t = got["state_f"].numpy().reshape(tr.NS_F, B)
        sf_j = np.asarray(ref["state_f"]).reshape(tr.NS_F, B)
        for i in _F_PLANES:
            # plane 38 is risk(prev CGM): the reward's atol.  Elsewhere an
            # absolute floor of 2e-6 of the plane's largest magnitude covers
            # cancellation (the PID integral, x6 near zero)
            atol = 1e-4 if i == 38 else 2e-6 * float(np.abs(sf_j[i]).max())
            np.testing.assert_allclose(sf_t[i], sf_j[i], rtol=2e-6, atol=atol, err_msg=f"plane {i}")
        si_t = got["state_i"].numpy().reshape(tr.NS_I, B)
        si_j = np.asarray(ref["state_i"]).reshape(tr.NS_I, B)
        np.testing.assert_array_equal(si_t[_I_PLANES], si_j[_I_PLANES])
    np.testing.assert_allclose(t0["BG0"].numpy(), np.asarray(j0["BG0"]), rtol=1e-7)
    np.testing.assert_allclose(t0["CGM0"].numpy(), np.asarray(j0["CGM0"]), rtol=1e-7)
    # the second call really continued: its clock is 2T minutes in
    assert (t1["state_i"][0] == 2 * T * tcfg.sample_time).all()


def test_deterministic_bb_with_meals_matches_env():
    """Static meal schedule + basal-bolus therapy: the eating state machine
    and the bolus path (announced CHO, Quest CR/CF, G>150 correction) vs the
    JAX env path, at the JAX kernel's tolerances."""
    names = cohort_names(B)
    quest = load_quest_params(names, dtype=np.float32)
    params, _, packed_t = _packed(names, quest=quest)
    T = 12
    times, amounts = (3, 10), (30.0, 25.0)
    got = tr.rollout(
        tr.RolloutConfig(n_steps=T, deterministic=True, controller="bb",
                         det_meal_times=times, det_meal_amounts=amounts),
        packed_t, 0,
    )
    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(times, amounts):
        meal_seq[t] = a
    _, ref = _env_traj(names, bb_policy(3), bb_params(params.patient, quest), T, meal_seq=meal_seq)
    assert got["CHO"].max() > 0, "meals must fire"
    assert got["insulin"].max() > got["insulin"].min(), "bolus must fire"
    _assert_traj(got, ref)


@pytest.mark.parametrize("sensor", ["Navigator", "GuardianRT"])  # sample_time 1 and 5
def test_deterministic_other_sensors_match_env(sensor):
    """The sample time changes the minute loop and the step cadence; the
    port matches the env path for st=1 and st=5 at the same tolerances."""
    names = cohort_names(B)
    _, _, packed_t = _packed(names, sensor=sensor)
    T = 4
    cfg = tr.config_for_sensor(sensor, n_steps=T, deterministic=True, controller="pid")
    got = tr.rollout(cfg, packed_t, 0)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    _, ref = _env_traj(names, ctrl, broadcast_ctrl_state(ctrl0, B), T, sensor=sensor)
    _assert_traj(got, ref)
