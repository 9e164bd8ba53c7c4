"""The fused trainer's observation-plane path on the CPU, where every kernel
runs its plain version: the learner ``_update`` against the JAX package's
with each of its three learners, the plane-prep stage against the JAX
functions, the two prep paths against each other, and whole iterations
with each learner.

Tolerances of the learner comparisons are the JAX package's own for its
kernel learners against its XLA learner (tests/test_pallas_ppo_learner.py:
139-149, 195-212): params and Adam's mu rtol 5e-3 / atol 3e-5, nu rtol 5e-3
/ atol 1e-7, the loss and entropy aux rtol 2e-3 / atol 1e-4.  Four Adam
steps amplify float32 summation-order differences most where a moment is
near zero.  The plane-prep stage computes the same float32 operations as
the JAX functions in another order: rtol 1e-5 / atol 1e-5 (1e-6 for the
features)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.rl import fused as jfused
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import fused as tfused
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

T, B, H = 8, 64, 16
TOL_PARAMS = dict(rtol=5e-3, atol=3e-5)
TOL_NU = dict(rtol=5e-3, atol=1e-7)
TOL_AUX = dict(rtol=2e-3, atol=1e-4)


def _transition(seed):
    """A [T, B] transition and its advantages/returns, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda loc, scale, shape=(T, B): rng.normal(loc, scale, shape).astype(np.float32)
    obs, raw, logp = f(0, 1, (T, B, 7)), f(-1, 1), f(-1.2, 0.3)
    value, reward = f(0, 2), f(0, 1)
    done = np.zeros((T, B), np.float32)
    advs, rets = f(0, 1), f(0, 2)
    return obs, raw, logp, value, reward, done, advs, rets


def _jax_and_port_policy(seed=3):
    jp = jpol.init_policy(jax.random.PRNGKey(seed), hidden=H, act="relu", init_mu_bias=-1.0)
    tp = tpol.policy_from_numpy([np.asarray(x) for x in jax.tree.leaves(jp)], act="relu",
                                device="cpu")
    return jp, tp


@pytest.mark.parametrize("learner", ["step", "epoch", False])
def test_update_matches_jax(learner):
    """Two epochs x two minibatches over the same transition, the same
    permutations (the JAX key chain's, handed to the port) and the same
    optimizer state, one Adam step in (count 1, mu and nu not zero): the
    params, Adam's count/mu/nu and the aux.  The JAX 'step' and 'epoch'
    learners run their kernels in interpret mode, False its jax.grad
    learner."""
    arrays = _transition(0)
    cfg_kw = dict(epochs=2, minibatches=2, lr=1e-3, pallas_learner=learner)
    jcfg, tcfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jp, tp = _jax_and_port_policy()
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

    obs, raw, logp, value, reward, done, advs, rets = (jnp.asarray(a) for a in arrays)
    jtr = jppo.Transition(obs, raw, logp, value, reward, done)
    jp2, jstate2, _, jaux = jppo._update(jcfg, jopt, jp, jstate, jtr, advs, rets, key, None,
                                         interpret=bool(learner))
    obs, raw, logp, value, reward, done, advs, rets = (torch.from_numpy(a) for a in arrays)
    ttr = tppo.Transition(obs, raw, logp, value, reward, done)
    tp2, tstate2, taux = tppo._update(tcfg, tppo.make_optimizer(tcfg), tp,
                                      tppo.opt_state_from_optax(jstate, device="cpu"), ttr, advs,
                                      rets, perms=perms)

    for name, got in zip(tpol.LEAVES, tp2.leaves()):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jp2, name)), err_msg=name,
                                   **TOL_PARAMS)
    moved = max(float((a - b).abs().max()) for a, b in zip(tp2.leaves(), tp.leaves()))
    assert moved > 1e-3, "the learner must move the params"
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    assert tstate2.count == jadam.count == 1 + 4
    np.testing.assert_allclose(tstate2.mu.numpy(), jadam.mu.numpy(), **TOL_PARAMS)
    np.testing.assert_allclose(tstate2.nu.numpy(), jadam.nu.numpy(), **TOL_NU)
    for got, ref in zip(taux, jaux):
        assert tuple(got.shape) == (2, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_AUX)


def test_epoch_and_step_learners_agree_exactly():
    """On the CPU the 'epoch' learner's plain version is the 'step'
    learner's loop: the same params, Adam state and aux, bit for bit."""
    arrays = [torch.from_numpy(a) for a in _transition(2)]
    ttr = tppo.Transition(*arrays[:6])
    _, tp = _jax_and_port_policy(4)
    out = {}
    for learner in ("step", "epoch"):
        cfg = tppo.PPOConfig(epochs=2, minibatches=4, pallas_learner=learner)
        opt = tppo.make_optimizer(cfg)
        out[learner] = tppo._update(cfg, opt, tp, opt.init(tp), ttr, arrays[6], arrays[7],
                                    generator=torch.Generator().manual_seed(5))
    (pa, sa, aa), (pb, sb, ab) = out["step"], out["epoch"]
    assert all(torch.equal(a, b) for a, b in zip(pa.leaves(), pb.leaves()))
    assert sa.count == sb.count == 8
    assert torch.equal(sa.mu, sb.mu) and torch.equal(sa.nu, sb.nu)
    assert all(torch.equal(a, b) for a, b in zip(aa, ab))


def test_epoch_learner_needs_whole_minibatches_of_blocks():
    """The JAX package's ValueError: 'epoch' needs the shuffle-block count
    divisible by the minibatches (256 blocks of 2 rows, 3 minibatches)."""
    arrays = [torch.from_numpy(a) for a in _transition(3)]
    cfg = tppo.PPOConfig(minibatches=3, pallas_learner="epoch")
    _, tp = _jax_and_port_policy()
    opt = tppo.make_optimizer(cfg)
    with pytest.raises(ValueError, match="divisible by minibatches"):
        tppo._update(cfg, opt, tp, opt.init(tp), tppo.Transition(*arrays[:6]), arrays[6],
                     arrays[7], generator=torch.Generator())


def test_plane_prep_matches_jax():
    """Features from the observation planes, the recomputed value and
    log-prob, the tail value and GAE, against the JAX functions the
    plane path calls, on the same planes."""
    rng = np.random.default_rng(6)
    u = lambda lo, hi, shape=(T, B): rng.uniform(lo, hi, shape).astype(np.float32)
    planes = dict(octrl=u(40, 400), oins=u(0, 0.05), ocho=u(0, 20) * (u(0, 1) < 0.1),
                  oiob=u(0, 3))
    planes["oprev"] = planes["octrl"] + rng.normal(0, 5, (T, B)).astype(np.float32)
    tail = {k: v[-1] * 1.01 for k, v in planes.items()}
    basal = u(0.01, 0.06, (B,))
    raw = rng.normal(-1, 1, (T, B)).astype(np.float32)
    reward = rng.normal(0, 1, (T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.05
    order = ("octrl", "oins", "ocho", "oprev", "oiob")
    jp, tp = _jax_and_port_policy(5)

    jobs = jfused._features(*(jnp.asarray(planes[k]) for k in order), jnp.asarray(basal))
    jmu, jls, jv = jpol.policy_apply(jp, jobs)
    jlogp = jpol.gaussian_logprob(jmu, jls, jnp.asarray(raw))
    jtail = jfused._features(*(jnp.asarray(tail[k]) for k in order), jnp.asarray(basal))
    jlast = jpol.policy_apply(jp, jtail)[2]
    jtr = jppo.Transition(jobs, raw, jlogp, jv, jnp.asarray(reward), jnp.asarray(done))
    jadv, jret = jppo._gae(jppo.PPOConfig(), jtr, jlast)

    t = lambda a: torch.from_numpy(np.asarray(a))
    tobs = tfused._features(*(t(planes[k]) for k in order), t(basal))
    tmu, tls, tv = tpol.policy_apply(tp, tobs)
    tlogp = tpol.gaussian_logprob(tmu, tls, t(raw))
    ttail = tfused._features(*(t(tail[k]) for k in order), t(basal))
    tlast = tpol.policy_apply(tp, ttail)[2]
    ttr = tppo.Transition(tobs, t(raw), tlogp, tv, t(reward), t(done))
    tadv, tret = tppo._gae(tppo.PPOConfig(), ttr, tlast)

    assert tobs.shape == (T, B, 7)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail), rtol=1e-6, atol=1e-6)
    for got, ref in ((tv, jv), (tlogp, jlogp), (tlast, jlast), (tadv, jadv), (tret, jret)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Whole iterations
# ---------------------------------------------------------------------------

BI = 128


@pytest.fixture(scope="module")
def packed():
    names = tables.cohort_names(BI)
    p = tables.load_patient_params(names, device="cpu")
    return tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))


def _state(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    pol = tpol.init_policy(g, hidden=H, act="relu", init_mu_bias=-2.2, device="cpu")
    return tfused.init_fused_state(pol, tppo.make_optimizer(cfg).init(pol), BI, g)


def test_kernel_prep_matches_plane_prep(packed):
    """The same iteration through both paths (mirrors the JAX package's
    tests/test_fused_ppo.py::test_kernel_prep_matches_plane_prep): the same
    seed gives the same deterministic rollout and the same minibatches; the
    rollout's in-kernel log-prob and value against the plane path's
    recomputation differ in float order only."""
    cfg = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, pallas_learner="step")
    over = dict(deterministic=True)
    ts_a, m_a = tfused.make_fused_train_step(cfg, BI, hidden=H, kernel_prep=False,
                                             rollout_overrides=over)(packed, _state(cfg))
    ts_b, m_b = tfused.make_fused_train_step(cfg, BI, hidden=H, kernel_prep=True,
                                             rollout_overrides=over)(packed, _state(cfg))
    np.testing.assert_allclose(float(m_a["reward_mean"]), float(m_b["reward_mean"]), rtol=1e-5)
    assert float(m_a["done_frac"]) == float(m_b["done_frac"])
    for a, b in zip(ts_a.params.leaves(), ts_b.params.leaves()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-5)
    assert torch.equal(ts_a.state_f, ts_b.state_f) and torch.equal(ts_a.state_i, ts_b.state_i)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(m_a[k]), float(m_b[k]), **TOL_AUX)


@pytest.mark.parametrize("learner", ["step", "epoch", False])
def test_plane_path_trains_with_each_learner(packed, learner):
    """kernel_prep=False with each learner (False is PPOConfig()'s
    default): metrics finite, params updated, Adam's count advanced, and
    the episode state carried into a second iteration."""
    cfg = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, pallas_learner=learner)
    step = tfused.make_fused_train_step(cfg, BI, hidden=H, kernel_prep=False)
    ts = _state(cfg, seed=1)
    ts1, m1 = step(packed, ts)
    assert set(m1) == {"reward_mean", "done_frac", "pg_loss", "v_loss", "entropy"}
    for k, v in m1.items():
        assert np.isfinite(float(v)), k
    assert any(not torch.equal(a, b) for a, b in zip(ts.params.leaves(), ts1.params.leaves()))
    assert ts1.init == 0 and ts1.opt_state.count == cfg.epochs * cfg.minibatches
    t_min1 = ts1.state_i[0].clone()
    ts2, m2 = step(packed, ts1)
    assert np.isfinite(float(m2["pg_loss"])) and ts2.opt_state.count == 2 * cfg.minibatches
    assert (ts2.state_i[0] > t_min1).double().mean() > 0.8
    ts_f, m_f = tfused.make_fused_train_step(cfg, BI, hidden=H, stages="forward")(packed, ts2)
    assert {"adv_mean", "ret_mean", "logp_mean"} <= set(m_f) and ts_f.params is ts2.params


@pytest.mark.parametrize("learner,kw", [
    ("epoch", dict(kernel_prep=True)),
    (False, dict(kernel_prep=True)),
    ("step", dict(kernel_prep=True, mesh=object())),
])
def test_kernel_prep_eligibility_like_jax(learner, kw):
    """kernel_prep defaults to True exactly where eligible; asking for it
    elsewhere raises the JAX package's ValueError."""
    cfg = tppo.PPOConfig(pallas_learner=learner)
    with pytest.raises(ValueError, match="kernel_prep=True needs"):
        tfused.make_fused_train_step(cfg, BI, hidden=H, **kw)
