"""The port's rollouts over the eager env path against the JAX package's,
and the port's two engines against each other.

Every case runs the reference's MT19937 noise (exogenous) and a custom or
exogenous meal scenario, so nothing is drawn from a generator: both stacks
see the same streams.  After an auto-reset that stays true: the fresh
episode starts at x0, reads the noise from its first pop and the meals from
its own clock; only the random start hour differs, which neither mode
reads.  Tolerances as tests/test_torch_env_step.py (float64 rtol 1e-12;
float32 BG/CGM rtol 2e-6, insulin rtol 1e-6 or one increment on <= 1% of
the doses, CHO to 2 ulps, reward atol 1e-4).

The cross-engine case holds the plain version of the rollout kernel K1a
(``scenario_kind='static'``, exogenous noise, BB: the config of
tests/test_torch_rollout_exo.py::test_static_scenario_stochastic_path_matches_env)
against the port's own ``make_batch_continue_fn`` with the kernel's
tolerances, but CHO to 2 ulps: the kernel multiplies by float32(1/st), as
XLA compiles the JAX package's division, where the eager path divides as
the reference does."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.compat.noise import reference_cgm_noise
from simglucose_tpu.controllers.functional import bb_controller, bb_params, bb_policy, pid_controller
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.params import load_quest_params, sensor_record
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.controllers import functional as tctl
from simglucose_tpu_torch.core.types import from_jax, tree_map
from simglucose_tpu_torch.envs import build as tbuild
from simglucose_tpu_torch.envs.functional import EnvConfig
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.ops.streams import env_keys

from test_torch_env_step import check_insulin, check_results

jro = importlib.import_module("simglucose_tpu.envs.rollout")  # the package exports a function of that name
tro = importlib.import_module("simglucose_tpu_torch.envs.rollout")
torch.set_num_threads(1)

TIMES, AMOUNTS = np.array([3, 10, 60], np.int32), np.array([30.0, 25.0, 50.0])


def _env(names, dtype, T, batch=True, **kw):
    """JAX (cfg, params) with the reference noise and the custom meals, and
    the port's from the same arrays."""
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 4)
    common = dict(noise_seq=noise, custom_times=TIMES, custom_amounts=AMOUNTS, scenario_mode="custom",
                  substeps=kw.pop("substeps", 1), method=kw.pop("method", "rk4"))
    jcfg, jparams = make_env(names, batch=batch, dtype=dtype, **common)
    tcfg, tparams = tbuild.make_env(names, batch=batch, dtype=dtype, device="cpu", **common)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if kw:
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    return jcfg, jparams, tcfg, tparams


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


@pytest.mark.parametrize("dtype,substeps,method", [(np.float64, 4, "rk45"), (np.float32, 1, "rk4")],
                         ids=["f64", "f32"])
def test_rollout_single_env(dtype, substeps, method):
    """``rollout`` of one env with 0-d parameter leaves (make_env
    batch=False), BB closed over, 40 steps: the reset row and every step."""
    T = 40
    jcfg, jparams, tcfg, tparams = _env("adolescent#001", dtype, T, batch=False, substeps=substeps,
                                        method=method)
    quest = jax.tree.map(lambda a: a[0], load_quest_params("adolescent#001", dtype=dtype))
    j0, jfn = bb_controller(bb_params(jparams.patient, quest), 3)
    _, jreset, jtraj = jax.jit(lambda k: jro.rollout(jcfg, jparams, k, j0, jfn, T))(jax.random.PRNGKey(0))
    tquest = tree_map(lambda a: a[0], tables.load_quest_params("adolescent#001", dtype=_tdtype(dtype),
                                                                device="cpu"))
    t0, tfn = tctl.bb_controller(tctl.bb_params(tparams.patient, tquest), 3)
    tstate, treset, ttraj = tro.rollout(tcfg, tparams, env_keys(0, 1, device="cpu")[0], t0, tfn, T)
    assert ttraj.BG.shape == (T,) and treset.BG.shape == ()
    check_results(treset, jreset, dtype)
    check_results(ttraj, jtraj, dtype)
    assert float(ttraj.CHO.sum()) > 0 and int(tstate.patient.t) == 3 * T


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("controller", ["bb", "pid"])
def test_rollout_batch(dtype, controller):
    """``rollout_batch`` at B = 8: BB with per-patient state (in_axes 0),
    PID with a shared state (in_axes None); histories [B, T]."""
    B, T = 8, 30
    names = cohort_names(B)
    jcfg, jparams, tcfg, tparams = _env(names, dtype, T)
    if controller == "bb":
        jinit = bb_params(jparams.patient, load_quest_params(names, dtype=dtype))
        jfn, axes = bb_policy(3), 0
        tinit = from_jax(jinit, device="cpu")
        tfn = tctl.bb_policy(3)
    else:
        jinit, jfn = pid_controller(3, P=-1e-4, I=-1e-7, dtype=dtype)
        axes = None
        tinit, tfn = tctl.pid_controller(3, P=-1e-4, I=-1e-7, dtype=_tdtype(dtype), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    _, jreset, jtraj = jro.rollout_batch(jcfg, jparams, keys, jinit, jfn, T, ctrl_in_axes=axes)
    _, treset, ttraj = tro.rollout_batch(tcfg, tparams, env_keys(1, B, device="cpu"), tinit, tfn, T,
                                         ctrl_in_axes=axes)
    assert ttraj.BG.shape == (B, T)
    check_results(treset, jreset, dtype)
    check_results(ttraj, jtraj, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_rollout_fn_autoreset(dtype):
    """``make_batch_rollout_fn`` at B = 16 with a low termination bound
    (BG > 150), so that lanes end and restart: the terminal results, the
    carried (reset) results and the final clocks."""
    B, T = 16, 40
    names = cohort_names(B)
    jcfg, jparams, tcfg, tparams = _env(names, dtype, T, bg_done_high=150.0)
    jinit, jfn = pid_controller(3, P=-1e-4, I=-1e-7, dtype=dtype)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jstate, jres = jro.batch_reset(jcfg, jparams, keys, start_min=0)
    jrun = jro.make_batch_rollout_fn(jcfg, jfn, T, donate=False)
    jstate, jlast, jtraj = jrun(jparams, jstate, jro.broadcast_ctrl_state(jinit, B), jres)

    tinit, tfn = tctl.pid_controller(3, P=-1e-4, I=-1e-7, dtype=_tdtype(dtype), device="cpu")
    tstate, tres = tro.batch_reset(tcfg, tparams, env_keys(2, B, device="cpu"), start_min=0)
    trun = tro.make_batch_rollout_fn(tcfg, tfn, T)
    tstate, tlast, ttraj = trun(tparams, tstate, tro.broadcast_ctrl_state(tinit, B), tres)
    done = ttraj.done.numpy()
    assert done.sum() >= 5 and (done.sum(0) >= 2).any()  # resets, some lanes more than once
    check_results(ttraj, jtraj, dtype)
    check_results(tlast, jlast, dtype)
    for f in ("t",):
        np.testing.assert_array_equal(getattr(tstate.patient, f).numpy(), np.asarray(getattr(jstate.patient, f)))
    np.testing.assert_array_equal(tstate.episode_step.numpy(), np.asarray(jstate.episode_step))
    # every reset took a fresh episode counter, and only the reset lanes
    ended = done.any(0)
    assert (tstate.key[:, 3].numpy() != 0).tolist() == ended.tolist()


def test_autoreset_with_candidates_and_horizon():
    """``autoreset_step_with_candidate`` (one candidate; C candidates with
    an adoption count) and ``autoreset_step(horizon_steps=...)`` against
    JAX, float64, B = 8, from a common state, for 12 steps."""
    B, T, dtype = 8, 12, np.float64
    names = cohort_names(B)
    jcfg, jparams, tcfg, tparams = _env(names, dtype, T, bg_done_high=150.0)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jres = jro.batch_reset(jcfg, jparams, keys, start_min=0)
    tstate, tres = tro.batch_reset(tcfg, tparams, env_keys(3, B, device="cpu"), start_min=0)
    jinit, jfn = pid_controller(3, P=-1e-4, I=-1e-7, dtype=dtype)
    tinit, tfn = tctl.pid_controller(3, P=-1e-4, I=-1e-7, dtype=torch.float64, device="cpu")
    jcand, jcres = jax.vmap(lambda p, s: jro.make_reset_candidates(jcfg, p, s))(jparams, jstate)
    tcand, tcres = tro.make_reset_candidates(tcfg, tparams, tstate)
    tcand2, tcres2 = tro.make_reset_candidates(tcfg, tparams, tstate, salt=1)
    assert not torch.equal(tcand.key, tcand2.key)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), jcand, jcand)
    jrstack = jax.tree.map(lambda *xs: jnp.stack(xs), jcres, jcres)
    tstack = tree_map(lambda *xs: torch.stack(xs), tcand, tcand2)
    trstack = tree_map(lambda *xs: torch.stack(xs), tcres, tcres2)
    states = dict(one=(jstate, tstate), many=(jstate, tstate), horizon=(jstate, tstate))
    results = {k: (jres, tres) for k in states}
    jn = jnp.zeros(B, jnp.int32)
    tn = torch.zeros(B, dtype=torch.int32)
    jci = jro.broadcast_ctrl_state(jinit, B)
    tci = tro.broadcast_ctrl_state(tinit, B)
    ctrl = {k: (jci, tci) for k in states}
    jpolicy = jax.vmap(jfn)
    jsteps = dict(
        one=jax.jit(jax.vmap(lambda p, s, a, c, r: jro.autoreset_step_with_candidate(jcfg, p, s, a, c, r))),
        many=jax.jit(jax.vmap(lambda p, s, a, c, r, n: jro.autoreset_step_with_candidate(jcfg, p, s, a, c, r, n),
                              in_axes=(0, 0, 0, 1, 1, 0))),
        horizon=jax.jit(jax.vmap(lambda p, s, a: jro.autoreset_step(jcfg, p, s, a, horizon_steps=5))),
    )
    for _ in range(T):
        for k in states:
            (js, ts), (jr, trr), (jc, tc) = states[k], results[k], ctrl[k]
            jc, ja = jpolicy(jc, jr)
            tc, ta = tfn(tc, trr)
            if k == "one":
                js, jres_, jr = jsteps[k](jparams, js, ja, jcand, jcres)
                ts, tres_, trr = tro.autoreset_step_with_candidate(tcfg, tparams, ts, ta, tcand, tcres)
            elif k == "many":
                js, jres_, jr, jn = jsteps[k](jparams, js, ja, jstack, jrstack, jn)
                ts, tres_, trr, tn = tro.autoreset_step_with_candidate(tcfg, tparams, ts, ta, tstack,
                                                                       trstack, tn)
            else:
                js, jres_, jr, jtr = jsteps[k](jparams, js, ja)
                ts, tres_, trr, ttr = tro.autoreset_step(tcfg, tparams, ts, ta, horizon_steps=5)
                np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
            check_results(tres_, jres_, dtype)
            check_results(trr, jr, dtype)
            states[k], results[k], ctrl[k] = (js, ts), (jr, trr), (jc, tc)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.sum()) >= 3


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_continue_fn_in_chunks(dtype):
    """``make_batch_continue_fn`` at B = 32 in two chunks of 15 steps (the
    controller state and last result carried) against JAX's."""
    B, T = 32, 15
    names = cohort_names(B)
    jcfg, jparams, tcfg, tparams = _env(names, dtype, 2 * T)
    jinit, jfn = pid_controller(3, P=-2e-4, I=-1e-7, D=-1e-3, dtype=dtype)
    tinit, tfn = tctl.pid_controller(3, P=-2e-4, I=-1e-7, D=-1e-3, dtype=_tdtype(dtype), device="cpu")
    jstate, jres = jro.batch_reset(jcfg, jparams, jax.random.split(jax.random.PRNGKey(4), B), start_min=0)
    tstate, tres = tro.batch_reset(tcfg, tparams, env_keys(4, B, device="cpu"), start_min=0)
    jrun = jro.make_batch_continue_fn(jcfg, jfn, T)
    trun = tro.make_batch_continue_fn(tcfg, tfn, T)
    jc, tc = jro.broadcast_ctrl_state(jinit, B), tro.broadcast_ctrl_state(tinit, B)
    for _ in range(2):
        jstate, jc, jres, jtraj = jrun(jparams, jstate, jc, jres)
        tstate, tc, tres, ttraj = trun(tparams, tstate, tc, tres)
        assert ttraj.BG.shape == (T, B)
        check_results(ttraj, jtraj, dtype)
    tol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(tc.integrated.numpy(), np.asarray(jc.integrated), rtol=tol)


def test_batch_reset_draws_start_hours():
    """Without ``start_min`` every env starts at its own random hour, fixed
    by its key."""
    B = 64
    _, _, tcfg, tparams = _env(cohort_names(B), np.float32, 4)
    keys = env_keys(9, B, device="cpu")
    s1, _ = tro.batch_reset(tcfg, tparams, keys)
    s2, _ = tro.batch_reset(tcfg, tparams, keys)
    start = s1.scenario.start_min.numpy()
    assert torch.equal(s1.scenario.start_min, s2.scenario.start_min)
    assert set(np.unique(start % 60)) == {0} and 12 <= len(np.unique(start)) <= 24
    assert start.min() >= 0 and start.max() <= 23 * 60


def test_kernel_plain_version_equals_eager_path():
    """K1a's plain version and the eager path on one config: 128 patients,
    48 steps, BB, meals at episode minutes 3, 10 and 60, x0 init, the
    reference noise, float32 rk4; every trajectory plane and the reset
    CGM within the kernel's tolerances (tests/test_torch_rollout_exo.py)."""
    B, T = 128, 48
    names = tables.cohort_names(B)
    patient = tables.load_patient_params(names, device="cpu")
    quest = tables.load_quest_params(names, device="cpu")
    packed = tr.pack_params(patient, basal_rate(patient), quest=quest)
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(np.float32)
    bc = lambda a: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a[:, None, None], (len(a), 1, 128))))
    cfg = tr.RolloutConfig(n_steps=T, deterministic=False, scenario_kind="static", exogenous_noise=True,
                           autoreset=False, random_init_bg=False, fixed_start_min=0, controller="bb",
                           det_meal_times=tuple(int(t) for t in TIMES),
                           det_meal_amounts=tuple(float(a) for a in AMOUNTS))
    kern = tr.rollout(cfg, packed, 5, reset_noise=bc(noise[:2]), step_noise=bc(noise[2:]))

    tcfg, tparams = tbuild.make_env(names, batch=True, device="cpu", noise_seq=noise,
                                    custom_times=TIMES, custom_amounts=AMOUNTS.astype(np.float32),
                                    scenario_mode="custom")
    assert tcfg == EnvConfig(method="rk4", noise_mode="exogenous", scenario_mode="custom")
    state, res = tro.batch_reset(tcfg, tparams, env_keys(5, B, device="cpu"), start_min=0)
    run = tro.make_batch_continue_fn(tcfg, tctl.bb_policy(3), T)
    _, _, _, traj = run(tparams, state, tctl.bb_params(patient, quest), res)
    for k, kw in (("BG", dict(rtol=2e-6)), ("CGM", dict(rtol=2e-6)), ("reward", dict(atol=1e-4))):
        np.testing.assert_allclose(getattr(traj, k).numpy(), kern[k].numpy(), err_msg=k, **kw)
    check_insulin(traj.insulin.numpy(), kern["insulin"].numpy())
    np.testing.assert_allclose(traj.CHO.numpy(), kern["CHO"].numpy(), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(traj.done.numpy(), kern["done"].numpy().astype(bool))
    np.testing.assert_allclose(res.CGM.numpy(), kern["CGM0"].numpy(), rtol=1e-6)
    assert float(traj.CHO.sum()) > 0
