"""Port fused PPO training (rl/fused.py, rl/ppo.py) on the CPU, where every
stage runs its kernel's plain version: the learner against the JAX
``_update_packed`` on the same permutations, then whole iterations.

Tolerance of the learner comparison: rtol 5e-3 / atol 2e-5, the JAX
package's own for its kernel learner against its XLA learner
(tests/test_pallas_ppo_learner.py:139-149): four Adam steps amplify the
grad step's float32 summation-order differences, most where a moment is
near zero."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import ppo_learner as lrn
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.parallel.sharding import Mesh
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo
from simglucose_tpu_torch.rl.fused import (
    fused_rollout_config,
    init_fused_state,
    make_fused_train_loop,
    make_fused_train_step,
    plane_transition,
)

torch.set_num_threads(1)

B, H = 128, 16
TRAINING_MODULES = [
    "simglucose_tpu_torch.rl.policy",
    "simglucose_tpu_torch.rl.ppo",
    "simglucose_tpu_torch.rl.fused",
    "simglucose_tpu_torch.ops.ppo_learner",
    "simglucose_tpu_torch.ops.rollout",
    "simglucose_tpu_torch.ops.build",
]


def test_training_path_imports_no_jax_optax_pandas_matplotlib():
    code = (
        "import importlib, sys\n"
        f"for m in {TRAINING_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'optax', 'pandas', 'matplotlib') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_update_packed_matches_jax_learner():
    """Two epochs x two minibatches of grad step + clip + Adam over the same
    learner rows, advantages and permutations (the JAX key chain's, handed
    to the port) and the same starting Adam state."""
    rng = np.random.default_rng(0)
    T, Bl = 8, 256
    N = T * Bl
    main = np.zeros((10, N), np.float32)
    main[0:7] = rng.normal(0, 1, (7, N))
    main[7] = rng.normal(0, 3, N)
    main[8] = rng.normal(-1, 1, N)
    main[9] = rng.normal(-1.2, 0.3, N)
    advret = rng.normal(0, 1, (2, N)).astype(np.float32)
    cfg_kw = dict(epochs=2, minibatches=2, shuffle_block=64, lr=1e-3)
    jcfg, tcfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jp = jpol.init_policy(jax.random.PRNGKey(3), hidden=H, act="relu", init_mu_bias=-1.0)
    tp = tpol.policy_from_numpy([np.asarray(x) for x in jax.tree.leaves(jp)], act="relu", device="cpu")
    jopt = jppo.make_optimizer(jcfg)
    jstate = jopt.init(jp)
    key = jax.random.PRNGKey(11)

    _, n_blocks, _ = tppo._shuffle_blocking(tcfg, N)
    perms, k = [], key
    for _ in range(tcfg.epochs):
        k, k_perm = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(k_perm, n_blocks)))

    jp2, jstate2, _, jaux = jppo._update_packed(
        jcfg, jopt, jp, jstate, jnp.asarray(main), jnp.asarray(advret), key, interpret=True)
    tp2, tstate2, taux = tppo._update_packed(
        tcfg, tppo.make_optimizer(tcfg), tp, tppo.opt_state_from_optax(jstate, device="cpu"),
        torch.from_numpy(main), torch.from_numpy(advret), perms=perms)

    tol = dict(rtol=5e-3, atol=2e-5)
    for name, got in zip(tpol.LEAVES, tp2.leaves()):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jp2, name)), err_msg=name, **tol)
    moved = max(float((a - b).abs().max()) for a, b in zip(tp2.leaves(), tp.leaves()))
    assert moved > 1e-3, "the learner must move the params"
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    assert tstate2.count == jadam.count == 4
    np.testing.assert_allclose(tstate2.mu.numpy(), jadam.mu.numpy(), **tol)
    np.testing.assert_allclose(tstate2.nu.numpy(), jadam.nu.numpy(), rtol=5e-3, atol=1e-9)
    for got, ref in zip(taux, jaux):
        assert tuple(got.shape) == (2, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_update_packed_is_the_step_learner_on_the_same_rows():
    """``_update_packed`` (K3 over the rollout's [10, N] rows and the [2, N]
    GAE pack) and ``_update(pallas_learner='step')`` (K4 over the 12-row
    buffer of the same rows as a [T, B] transition) run one loop: on the
    same permutations they give the same params, Adam state and losses."""
    rng = np.random.default_rng(1)
    T, Bl = 8, 256
    N = T * Bl
    main = np.zeros((10, N), np.float32)
    main[0:7] = rng.normal(0, 1, (7, N))
    main[7] = rng.normal(0, 3, N)
    main[8] = rng.normal(-1, 1, N)
    main[9] = rng.normal(-1.2, 0.3, N)
    advret = rng.normal(0, 1, (2, N)).astype(np.float32)
    cfg = tppo.PPOConfig(epochs=2, minibatches=2, shuffle_block=64, lr=1e-3, pallas_learner="step")
    _, n_blocks, _ = tppo._shuffle_blocking(cfg, N)
    perms = [rng.permutation(n_blocks) for _ in range(cfg.epochs)]
    p0 = tpol.init_policy(torch.Generator().manual_seed(4), hidden=H, act="relu",
                          init_mu_bias=-1.0, device="cpu")
    opt = tppo.make_optimizer(cfg)
    main_t, advret_t = torch.from_numpy(main), torch.from_numpy(advret)
    traj = tppo.Transition(
        obs=main_t[0:7].T.reshape(T, Bl, 7), raw_action=main_t[8].reshape(T, Bl),
        logp=main_t[9].reshape(T, Bl), value=main_t[7].reshape(T, Bl),
        reward=torch.zeros(T, Bl), done=torch.zeros(T, Bl, dtype=torch.bool))
    got = tppo._update_packed(cfg, opt, p0, opt.init(p0), main_t, advret_t, perms=perms)
    want = tppo._update(cfg, opt, p0, opt.init(p0), traj, advret_t[0].reshape(T, Bl),
                        advret_t[1].reshape(T, Bl), perms=perms)
    tol = dict(rtol=1e-5, atol=1e-7)
    for name, a, b in zip(tpol.LEAVES, got[0].leaves(), want[0].leaves()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)
    assert max(float((a - b).abs().max()) for a, b in zip(got[0].leaves(), p0.leaves())) > 1e-3
    assert got[1].count == want[1].count == cfg.epochs * cfg.minibatches
    np.testing.assert_allclose(got[1].mu.numpy(), want[1].mu.numpy(), **tol)
    np.testing.assert_allclose(got[1].nu.numpy(), want[1].nu.numpy(), rtol=1e-5, atol=1e-12)
    for a, b in zip(got[2], want[2]):
        assert tuple(a.shape) == (cfg.epochs, cfg.minibatches)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


@pytest.fixture(scope="module")
def packed():
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    return tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))


def _state(cfg, seed=0, **policy_kw):
    g = torch.Generator().manual_seed(seed)
    pol = tpol.init_policy(g, hidden=H, act="relu", init_mu_bias=-2.2, **policy_kw, device="cpu")
    return init_fused_state(pol, tppo.make_optimizer(cfg).init(pol), B, g)


CFG = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, pallas_learner=True)


def test_fused_train_step_runs_and_carries_state(packed):
    """Metrics finite, params updated, and the episode state threads
    through: the second iteration continues episodes (clocks advance)
    rather than starting fresh ones."""
    ts = _state(CFG)
    step = make_fused_train_step(CFG, B, hidden=H)
    ts1, m1 = step(packed, ts)
    assert set(m1) == {"reward_mean", "done_frac", "pg_loss", "v_loss", "entropy"}
    for k, v in m1.items():
        assert np.isfinite(float(v)), k
    assert any(not torch.equal(a, b) for a, b in zip(ts.params.leaves(), ts1.params.leaves()))
    assert ts1.init == 0 and ts1.opt_state.count == CFG.epochs * CFG.minibatches
    t_min1 = ts1.state_i[0].clone()
    assert t_min1.max() > 0
    ts2, m2 = step(packed, ts1)
    assert np.isfinite(float(m2["reward_mean"]))
    assert (ts2.state_i[0] > t_min1).double().mean() > 0.8


@pytest.mark.parametrize("learner", ["step", "epoch", False])
def test_plane_path_trains_with_the_bf16_learner(packed, learner):
    """``learner_bf16`` on the observation-plane path, with each learner:
    one iteration from the same state and seeds as the float32 run gives
    the same rollout, finite metrics and other params (its recomputed
    log-probs and its learner run at bfloat16)."""
    out = {}
    for bf16 in (False, True):
        cfg = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, pallas_learner=learner,
                             learner_bf16=bf16)
        ts = _state(cfg, seed=4)
        out[bf16] = (ts,) + make_fused_train_step(cfg, B, hidden=H, kernel_prep=False)(packed, ts)
    (ts, ts32, m32), (_, ts16, m16) = out[False], out[True]
    assert torch.equal(ts32.state_f, ts16.state_f)
    assert float(m32["reward_mean"]) == float(m16["reward_mean"])
    for k, v in m16.items():
        assert np.isfinite(float(v)), k
    assert any(not torch.equal(a, b) for a, b in zip(ts.params.leaves(), ts16.params.leaves()))
    assert any(not torch.equal(a, b) for a, b in zip(ts32.params.leaves(), ts16.params.leaves()))


@pytest.mark.parametrize("bf16", [False, True])
def test_plane_recompute_runs_at_the_learners_dtype(packed, bf16):
    """The plane path's recomputed log-probs (``plane_transition``, the
    train step's own) against the learner's forward (``learner_logp``, the
    plain version of K4/K5's) at unchanged params and the learner's compute
    dtype: the epoch-0 ratio within 1e-5 of 1 (chip_smoke.py's ATOL_RATIO).
    At the other dtype it is more than 1e-4 off, so a recompute that
    ignored ``learner_bf16`` fails."""
    cfg = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, pallas_learner="step",
                         learner_bf16=bf16)
    p = _state(cfg, seed=4).params
    traj = tr.rollout(fused_rollout_config(cfg, hidden=H, kernel_prep=False), packed, (0, 1),
                      weights=tr.pack_policy_weights(p))
    tran, _ = plane_transition(cfg, p, traj, tr.packed_basal(packed), traj["reward"],
                               traj["done"].to(torch.float32))
    args = (tran.obs.reshape(-1, 7).T, traj["raw"].reshape(-1), p.w1, p.b1, p.w2, p.b2,
            torch.cat([p.w_mu, p.w_v], 1), torch.cat([p.b_mu, p.b_v]), p.log_std[0])
    err = {}
    for cdt in (torch.float32, torch.bfloat16):
        logp = lrn.learner_logp(*args, act="relu", compute_dtype=cdt)
        err[cdt] = float((torch.exp(logp - tran.logp.reshape(-1)) - 1.0).abs().max())
    own, other = (torch.bfloat16, torch.float32) if bf16 else (torch.float32, torch.bfloat16)
    assert err[own] <= 1e-5, err
    assert err[other] > 1e-4, err


def test_continuing_mode_and_the_loop(packed):
    """continuing=True: no auto-reset, so after three iterations every
    lane's episode clock reads 3 x 4 steps x 3 min even with a done
    threshold that would reset many; the loop stacks metrics per
    iteration."""
    ts = _state(CFG, seed=1)
    loop = make_fused_train_loop(CFG, B, 3, hidden=H, continuing=True,
                                 rollout_overrides=dict(bg_done_high=150.0))
    ts3, m = loop(packed, ts)
    assert all(tuple(v.shape) == (3,) for v in m.values())
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert float(m["done_frac"].max()) > 0.1, "the threshold must flag dones"
    assert (ts3.state_i[0] == 3 * 4 * 3).all()


def test_stages_and_reward_fn(packed):
    """'rollout' and 'forward' carry the state but leave params and the
    optimizer alone; reward_fn and done_penalty shape the reward."""
    ts = _state(CFG, seed=2)
    ts_r, m_r = make_fused_train_step(CFG, B, hidden=H, stages="rollout")(packed, ts)
    assert set(m_r) == {"reward_mean", "done_frac"} and ts_r.init == 0
    assert ts_r.params is ts.params and ts_r.opt_state is ts.opt_state
    ts_f, m_f = make_fused_train_step(CFG, B, hidden=H, stages="forward")(packed, ts)
    assert {"adv_mean", "ret_mean", "logp_mean"} <= set(m_f)
    assert ts_f.params is ts.params
    shaped = make_fused_train_step(CFG, B, hidden=H, stages="forward",
                                   reward_fn=lambda traj: torch.ones_like(traj["reward"]))
    _, m_s = shaped(packed, ts)
    assert float(m_s["reward_mean"]) == 1.0


def test_unported_paths_raise(packed):
    """A ``tp`` axis needs a live process group (``Mesh(dp=1, tp=2)``
    without one raises ValueError), and the mesh trainer refuses a hidden
    width that does not split over ``tp`` (H=16 over tp=3, with any
    learner: the plane prep raises before its first collective).  The bf16
    learner builds on the observation-plane path, which it
    takes by default, and asking for ``kernel_prep`` with it raises the
    JAX package's ValueError (the kernel's behaviour log-probs are
    float32).  A config whose action decoder disagrees with the params' is
    refused."""
    with pytest.raises(ValueError, match="live process group"):
        Mesh(dp=1, tp=2)
    tp3 = Mesh(dp=1, tp=3, live=True)
    for cfg in (CFG, tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2,
                                    pallas_learner="epoch")):
        with pytest.raises(ValueError, match="16 does not split over tp=3"):
            make_fused_train_step(cfg, B, hidden=H, mesh=tp3)(packed, _state(cfg))
    for cfg in (tppo.PPOConfig(pallas_learner=True, learner_bf16=True),
                tppo.PPOConfig(learner_bf16=True)):
        assert callable(make_fused_train_step(cfg, B, hidden=H))
        assert callable(make_fused_train_step(cfg, B, hidden=H, kernel_prep=False))
        with pytest.raises(ValueError, match="learner_bf16=False"):
            make_fused_train_step(cfg, B, hidden=H, kernel_prep=True)
    ts = _state(CFG, seed=3)
    with pytest.raises(ValueError, match="decoder mismatch"):
        make_fused_train_step(tppo.PPOConfig(pallas_learner=True, action_scale=10.0), B,
                              hidden=H)(packed, ts)


def test_shipped_checkpoint_runs_in_eval_mode(packed):
    """The shipped relu64 checkpoint drives a fixed-horizon cohort with mean
    actions (its trained decoder: basal-scaled sigmoid, scale 10): glucose
    stays finite and in the physiological range, and doses vary."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "checkpoints",
                        "ppo_cohort_relu64.npz")
    pol = tpol.load_policy_npz(path, act="relu", action_scale=10.0, scale_by_basal=True, device="cpu")
    cfg = tr.RolloutConfig(n_steps=20, controller="nn", nn_hidden=64, nn_action_scale=10.0,
                           nn_scale_by_basal=True, nn_sample_actions=False, autoreset=False,
                           fixed_start_min=420)
    out = tr.rollout(cfg, packed, (1, 2), weights=tr.pack_policy_weights(pol))
    assert torch.isfinite(out["BG"]).all() and torch.isfinite(out["raw"]).all()
    assert 40.0 < float(out["BG"].min()) and float(out["BG"].max()) < 400.0
    assert float(out["insulin"].std()) > 0
