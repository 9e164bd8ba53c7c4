"""The XLA-path trainer of the port (``rl/ppo.py::make_train_step`` over the
eager env) and the policy on the env (``featurize``, ``sample_action``,
``policy_controller``, ``evaluate_controller`` with an ``(init, fn)``
controller) against the JAX package's, on the CPU.

* ``_rollout`` step by step against JAX's ``featurize`` / ``policy_apply`` /
  ``autoreset_step``, both fed the same action normals (the port's Philox
  draws), the reference's MT19937 sensor noise and a custom meal scenario,
  with a low termination bound so that lanes end and restart (after a reset
  both stacks read the same streams: tests/test_torch_env_rollout.py).
  Tolerances: the env's as tests/test_torch_env_step.py holds them at
  float32 (BG/CGM rtol 2e-6, reward atol 1e-4, done exact; the carried
  CGM rtol 2e-6, insulin-on-board rtol 1e-5 / atol 1e-6); features, value,
  raw action and log-prob rtol 1e-5 / atol 1e-5.
* ``_gae`` and ``_update`` of one iteration on that trajectory, the same
  inputs and permutations to both: advantages and returns rtol 1e-5 / atol
  1e-5; the learners (autograd; 'step' and 'epoch', JAX's kernels in
  interpret mode, also at bfloat16) at tests/test_torch_plane.py's
  tolerances.
* ``policy_controller`` against JAX's on fixed inputs, both decoders: rtol
  1e-6 / atol 1e-9 over three calls.
* The fast cases of tests/test_ppo.py, and the pairing of eager-path
  evaluations at one seed.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.core.types import CtrlAction as JCtrlAction
from simglucose_tpu.core.types import Observation as JObservation
from simglucose_tpu.core.types import StepResult as JStepResult
from simglucose_tpu.envs.build import cohort_names
from simglucose_tpu.models.uva_padova import basal_rate as jbasal_rate
from simglucose_tpu.params import load_quest_params as jload_quest
from simglucose_tpu.rl import evaluate as jev
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.controllers.functional import bb_controller, bb_params
from simglucose_tpu_torch.core.types import Observation, StepResult
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops.streams import action_normal, env_keys
from simglucose_tpu_torch.parallel.sharding import Mesh
from simglucose_tpu_torch.rl import evaluate as tev
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

from test_torch_env_rollout import _env
from test_torch_env_step import check_results
from test_torch_plane import TOL_AUX, TOL_NU, TOL_PARAMS

jro = importlib.import_module("simglucose_tpu.envs.rollout")
tro = importlib.import_module("simglucose_tpu_torch.envs.rollout")
torch.set_num_threads(1)

B, T, H = 32, 16, 16
TOL_NN = dict(rtol=1e-5, atol=1e-5)


def _policies(seed=3, hidden=H, act="tanh", **kw):
    jp = jpol.init_policy(jax.random.PRNGKey(seed), hidden=hidden, act=act, init_mu_bias=-1.5,
                          **kw)
    tp = tpol.policy_from_numpy([np.asarray(x) for x in jax.tree.leaves(jp)], act=act,
                                device="cpu", **kw)
    return jp, tp


@pytest.fixture(scope="module")
def rollouts():
    """Both stacks' rollouts of T steps from the same reset, the port's
    through ``_rollout``, JAX's through its functions step by step on the
    port's action normals; and the JAX trajectory and carries."""
    cfg = tppo.PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=1e-3, done_penalty=2.0)
    jcfg, jparams, tcfg, tparams = _env(cohort_names(B), np.float32, T, bg_done_high=150.0)
    jstate, jres = jro.batch_reset(jcfg, jparams, jax.random.split(jax.random.PRNGKey(2), B),
                                   start_min=0)
    tstate, tres = tro.batch_reset(tcfg, tparams, env_keys(2, B, device="cpu"), start_min=0)
    jp, tp = _policies()
    key, step0 = env_keys((5, 6), B, device="cpu"), 3
    tbasal = basal_rate(tparams.patient)
    zero = torch.zeros(B)
    tout = tppo._rollout(cfg, tcfg, tparams, tp, tstate, tres, tres.observation.CGM, zero,
                         tbasal, key, step0)

    jbasal = jbasal_rate(jparams.patient)
    jstep = jax.jit(jax.vmap(lambda p, s, a: jro.autoreset_step(jcfg, p, s, a)))
    prev, cgm_prev, iob = jres, jres.observation.CGM, jnp.zeros(B, jnp.float32)
    rows = []
    for t in range(T):
        eps = jnp.asarray(action_normal(key, step0 + t, torch.float32).numpy())
        obs = jpol.featurize(prev, jbasal, cgm_prev=cgm_prev, iob=iob)
        mu, log_std, value = jpol.policy_apply(jp, obs)
        raw = mu + jnp.exp(log_std) * eps
        logp = jpol.gaussian_logprob(mu, log_std, raw)
        basal = jax.nn.sigmoid(raw) * cfg.action_scale
        jstate, res, carry = jstep(jparams, jstate, JCtrlAction(basal=basal,
                                                                bolus=jnp.zeros_like(basal)))
        reward = res.reward - cfg.done_penalty * res.done.astype(value.dtype)
        rows.append((obs, raw, logp, value, reward, res.done))
        cgm_prev = jnp.where(res.done, carry.observation.CGM, prev.observation.CGM)
        iob = jnp.where(res.done, 0.0, jpol.iob_step(iob, res.insulin, jcfg.sample_time))
        prev = carry
    jtraj = jppo.Transition(*(jnp.stack([r[i] for r in rows]) for i in range(6)))
    return dict(cfg=cfg, jp=jp, tp=tp, tout=tout, jtraj=jtraj, jlast=prev,
                jcarry=(cgm_prev, iob), jbasal=jbasal, tbasal=tbasal)


def test_rollout_matches_jax_step_by_step(rollouts):
    """Every transition, the terminal results, the last (reset) result and
    the observation-memory carries; lanes end and restart on the way."""
    r = rollouts
    _, tlast, tcgm, tiob, ttraj = r["tout"]
    jtraj = r["jtraj"]
    done = ttraj.done.numpy()
    assert ttraj.obs.shape == (T, B, 7) and done.sum() >= 3
    np.testing.assert_array_equal(done, np.asarray(jtraj.done))
    for f in ("obs", "raw_action", "logp", "value"):
        np.testing.assert_allclose(getattr(ttraj, f).numpy(), np.asarray(getattr(jtraj, f)),
                                   err_msg=f, **TOL_NN)
    np.testing.assert_allclose(ttraj.reward.numpy(), np.asarray(jtraj.reward), atol=1e-4)
    check_results(tlast, r["jlast"], np.float32)
    np.testing.assert_allclose(tcgm.numpy(), np.asarray(r["jcarry"][0]), rtol=2e-6)
    np.testing.assert_allclose(tiob.numpy(), np.asarray(r["jcarry"][1]), rtol=1e-5, atol=1e-6)
    assert float(tiob.abs().sum()) > 0


@pytest.mark.parametrize("learner,bf16", [(False, False), ("step", False), ("epoch", False),
                                          ("step", True), ("epoch", True)])
def test_gae_and_update_match_jax(rollouts, learner, bf16):
    """GAE over the port's trajectory in both packages, then one iteration
    of the learner on it, with the JAX key chain's permutations handed to
    the port and one Adam step already taken."""
    r = rollouts
    env_state, tlast, tcgm, tiob, ttraj = r["tout"]
    cfg_kw = dict(epochs=2, minibatches=2, lr=1e-3, pallas_learner=learner, learner_bf16=bf16)
    jcfg, tcfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jp, tp = r["jp"], r["tp"]
    last_value = tpol.policy_apply(tp, tpol.featurize(tlast, r["tbasal"], tcgm, tiob))[2]
    tadv, tret = tppo._gae(tcfg, ttraj, last_value)
    jtraj = jppo.Transition(*(jnp.asarray(x.numpy()) for x in ttraj))
    jadv, jret = jppo._gae(jcfg, jtraj, jnp.asarray(last_value.numpy()))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL_NN)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), **TOL_NN)

    jopt = jppo.make_optimizer(jcfg)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32), jp)
    _, jstate = jopt.update(g, jopt.init(jp), jp)
    key = jax.random.PRNGKey(11)
    _, n_blocks, _ = tppo._shuffle_blocking(tcfg, T * B)
    perms, k = [], key
    for _ in range(tcfg.epochs):
        k, k_perm = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(k_perm, n_blocks)))
    jp2, jstate2, _, jaux = jppo._update(jcfg, jopt, jp, jstate, jtraj, jnp.asarray(tadv.numpy()),
                                         jnp.asarray(tret.numpy()), key, None,
                                         interpret=bool(learner))
    tp2, tstate2, taux = tppo._update(tcfg, tppo.make_optimizer(tcfg), tp,
                                      tppo.opt_state_from_optax(jstate, device="cpu"), ttraj,
                                      tadv, tret, perms=perms)
    for name, got in zip(tpol.LEAVES, tp2.leaves()):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jp2, name)), err_msg=name,
                                   **TOL_PARAMS)
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    assert tstate2.count == jadam.count == 5
    np.testing.assert_allclose(tstate2.mu.numpy(), jadam.mu.numpy(), **TOL_PARAMS)
    np.testing.assert_allclose(tstate2.nu.numpy(), jadam.nu.numpy(), **TOL_NU)
    for got, ref in zip(taux, jaux):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_AUX)


# ---------------------------------------------------------------------------
# The fast cases of tests/test_ppo.py
# ---------------------------------------------------------------------------


def _setup(Bs=8, rollout_steps=4, **cfg_kw):
    cfg, env_params = make_env(tables.cohort_names(Bs), batch=True, random_init_bg=True,
                               device="cpu")
    keys = env_keys(0, Bs, device="cpu")
    env_state, reset_res = tro.batch_reset(cfg, env_params, keys)
    ppo_cfg = tppo.PPOConfig(rollout_steps=rollout_steps, epochs=1, minibatches=2, **cfg_kw)
    policy = tpol.init_policy(torch.Generator().manual_seed(1), hidden=32, device="cpu")
    ts = tppo.TrainState(params=policy, opt_state=tppo.make_optimizer(ppo_cfg).init(policy),
                         env_state=env_state, prev_res=reset_res,
                         key=env_keys((0, 1), Bs, device="cpu"),
                         generator=torch.Generator().manual_seed(2))
    return cfg, env_params, ppo_cfg, ts


def test_policy_sample_shapes():
    """One action per env, in [0, scale]; the same (key, step) draws the
    same normals, another step other ones, and a lane's normal does not
    depend on the batch it runs in."""
    Bs = 8
    cfg, env_params, _, ts = _setup(Bs)
    obs = tpol.featurize(ts.prev_res, basal_rate(env_params.patient))
    basal, raw, logp, value = tpol.sample_action(ts.params, obs, ts.key, 7)
    assert basal.shape == raw.shape == logp.shape == value.shape == (Bs,)
    assert bool((basal >= 0).all()) and bool((basal <= 0.2).all())
    again = tpol.sample_action(ts.params, obs, ts.key, 7)[1]
    other = tpol.sample_action(ts.params, obs, ts.key, 8)[1]
    assert torch.equal(raw, again) and not torch.equal(raw, other)
    half = action_normal(env_keys((0, 1), Bs // 2, device="cpu"), 7, torch.float32)
    assert torch.equal(half, action_normal(ts.key, 7, torch.float32)[: Bs // 2])
    z = action_normal(env_keys((0, 1), 4096, device="cpu"), 0, torch.float64)
    assert abs(float(z.mean())) < 0.06 and abs(float(z.std()) - 1.0) < 0.05


def test_action_decoder_mismatch_raises():
    cfg, env_params, _, ts = _setup(4)
    with pytest.raises(ValueError, match="action decoder mismatch"):
        tpol.check_action_decoder(ts.params, 10.0, True, "test")
    bad = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, action_scale=9.0)
    with pytest.raises(ValueError, match="action decoder mismatch"):
        tppo.make_train_step(bad, cfg)(env_params, ts)


@pytest.mark.parametrize("learner,bf16", [(False, False), ("step", False), ("epoch", False),
                                          (False, True), ("step", True)])
def test_train_step_updates_params_and_is_finite(learner, bf16):
    """Every learner (the kernels' plain versions here), float32 and bf16:
    metrics finite, params updated, and a second step composes with the
    carries and the action counter threaded."""
    cfg, env_params, ppo_cfg, ts = _setup(pallas_learner=learner, learner_bf16=bf16)
    step = tppo.make_train_step(ppo_cfg, cfg)
    ts2, m = step(env_params, ts)
    assert set(m) == {"reward_mean", "done_frac", "pg_loss", "v_loss", "entropy"}
    for k, v in m.items():
        assert np.isfinite(float(v)), k
    assert any(not torch.equal(a, b) for a, b in zip(ts.params.leaves(), ts2.params.leaves()))
    assert ts2.step == 4 and ts2.opt_state.count == 2 and ts2.cgm_prev.shape == (8,)
    ts3, m3 = step(env_params, ts2)
    assert np.isfinite(float(m3["reward_mean"])) and ts3.step == 8
    assert int(ts3.env_state.patient.t.min()) > int(ts2.env_state.patient.t.min()) or bool(
        ts3.env_state.key[:, 3].any())


def test_reference_style_reward_fun_in_train_step():
    """A reference-style 1-argument reward over the BG history, adapted by
    wrap_reward_fn: the reward is -CGM-scale."""
    cfg, env_params, ppo_cfg, ts = _setup()
    step = tppo.make_train_step(ppo_cfg, cfg, reward_fun=lambda bg_hist: -bg_hist[-1])
    _, m = step(env_params, ts)
    assert float(m["reward_mean"]) < -30.0


def test_unported_and_invalid_configs_raise():
    """reset_cadence > 1 is not ported; a mesh whose ``tp`` does not divide
    the policy's hidden width (32 over tp=3) raises ValueError at the first
    action, before any collective; the residual_bb decoder trains on the
    fused path only (the JAX package's ValueError)."""
    cfg, env_params, ppo_cfg, ts = _setup()
    with pytest.raises(NotImplementedError, match="Not ported"):
        tppo.make_train_step(dataclasses.replace(ppo_cfg, rollout_steps=8, reset_cadence=4), cfg)
    with pytest.raises(ValueError, match="32 does not split over tp=3"):
        tppo.make_train_step(ppo_cfg, cfg, mesh=Mesh(dp=1, tp=3, live=True))(env_params, ts)
    with pytest.raises(ValueError, match="'sigmoid' decoder only"):
        tppo.make_train_step(dataclasses.replace(ppo_cfg, decoder="residual_bb"), cfg)


# ---------------------------------------------------------------------------
# The policy as a controller, and evaluation on the eager env path
# ---------------------------------------------------------------------------


def _results(step, Bs):
    """The same three results as JAX and port StepResults: [Bs] leaves."""
    rng = np.random.default_rng(step)
    f = lambda lo, hi: rng.uniform(lo, hi, Bs).astype(np.float32)
    cgm, cho, ins = f(60, 300), f(0, 8) * (f(0, 1) < 0.5), f(0, 0.3)
    z = np.zeros(Bs, np.float32)
    fields = dict(reward=z, done=z > 1, CHO=cho, insulin=ins, BG=cgm, CGM=cgm, LBGI=z, HBGI=z,
                  risk=z)
    j = JStepResult(observation=JObservation(CGM=jnp.asarray(cgm)),
                    **{k: jnp.asarray(v) for k, v in fields.items()})
    t = StepResult(observation=Observation(CGM=torch.from_numpy(cgm)),
                   **{k: torch.from_numpy(v) for k, v in fields.items()})
    return j, t


@pytest.mark.parametrize("decoder", ["sigmoid", "residual_bb"])
def test_policy_controller_matches_jax(decoder):
    """Three calls of the deployed policy (mean action, the params'
    decoder) on the same results: the rates and the carried CGM and IOB."""
    Bs = 6
    names = tables.patient_names()[:Bs]
    kw = (dict(action_scale=1.1, decoder="residual_bb") if decoder == "residual_bb"
          else dict(action_scale=10.0, scale_by_basal=True))
    jp, tp = _policies(seed=7, act="relu", **kw)
    tpatient = tables.load_patient_params(names, device="cpu")
    tb = basal_rate(tpatient)
    quest = tables.load_quest_params(names, device="cpu")
    jquest = jload_quest(names, dtype=np.float32)
    ji, jf, jaxes = jev.policy_controller(jp, jnp.asarray(tb.numpy()), sample_time=3,
                                         quest=jquest)
    ti, tf, taxes = tev.policy_controller(tp, tb, sample_time=3, quest=quest)
    assert jaxes == taxes == 0
    jf = jax.vmap(jf)
    for step in range(3):
        jr, tr_ = _results(step, Bs)
        ji, ja = jf(ji, jr)
        ti, ta = tf(ti, tr_)
        np.testing.assert_allclose(ta.basal.numpy(), np.asarray(ja.basal), rtol=1e-6, atol=1e-9)
        assert float(ta.bolus.abs().max()) == 0.0
        for got, ref in zip(ti, ji):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
    if decoder == "residual_bb":
        with pytest.raises(ValueError, match="quest="):
            tev.policy_controller(tp, tb)


def test_eager_evaluations_are_paired():
    """Two (init, fn) controllers at one seed see the same meal scenario:
    the CHO every call reads is equal for the relu64 policy and BB, whose
    glucose differs; BB passed as an (init, fn) pair is the named BB on
    the same engine (float64, bit for bit); another seed draws other
    meals."""
    names = tables.patient_names()[:4]
    kw = dict(hours=6.0, seed=3, device="cpu")
    patient = tables.load_patient_params(names, device="cpu")
    quest = tables.load_quest_params(names, device="cpu")

    def recording(controller, seen):
        init, fn = controller[:2]

        def wrapped(state, result):
            seen.append(result.CHO.clone())
            return fn(state, result)

        return (init, wrapped) + tuple(controller[2:])

    relu64 = tpol.load_policy_npz("examples/checkpoints/ppo_cohort_relu64.npz", device="cpu",
                                  act="relu", action_scale=10.0, scale_by_basal=True)
    cho = {k: [] for k in ("policy", "bb", "other")}
    pol = tev.evaluate_controller(
        recording(tev.policy_controller(relu64, basal_rate(patient)), cho["policy"]), names, **kw)
    bb = tev.evaluate_controller(recording(bb_controller(bb_params(patient, quest), 3), cho["bb"]),
                                 names, **kw)
    tev.evaluate_controller(recording(bb_controller(bb_params(patient, quest), 3), cho["other"]),
                            names, hours=6.0, seed=4, device="cpu")
    assert pol["BG"].shape == bb["BG"].shape == (4, 120) and np.isfinite(pol["BG"]).all()
    assert not np.array_equal(pol["BG"], bb["BG"])
    seen = {k: torch.stack(v) for k, v in cho.items()}
    assert float(seen["policy"].sum()) > 0 and torch.equal(seen["policy"], seen["bb"])
    assert not torch.equal(seen["bb"], seen["other"])
    p64 = tables.load_patient_params(names, dtype=torch.float64, device="cpu")
    q64 = tables.load_quest_params(names, dtype=torch.float64, device="cpu")
    pair64 = tev.evaluate_controller(bb_controller(bb_params(p64, q64), 3), names,
                                     dtype=np.float64, **kw)
    named64 = tev.evaluate_controller("BB", names, dtype=np.float64, **kw)
    np.testing.assert_array_equal(pair64["BG"], named64["BG"])
    np.testing.assert_array_equal(pair64["CGM"], named64["CGM"])
