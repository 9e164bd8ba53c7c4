"""Checkpoints of the port (``simglucose_tpu_torch/utils/checkpoint.py``):
the five npz tests of tests/test_checkpoint.py on the port's records, a
fused-PPO and a ``make_train_step`` state resumed bit for bit on the CPU
(the kernels' plain versions), and the checks across the two stacks: a
``PolicyParams`` interchanges with the JAX package's ``save_state`` /
``restore_state`` bit for bit both ways, the shipped example checkpoints
restore as ``load_policy_npz`` reads them, and a JAX ``TrainState`` file
does not restore into a port ``TrainState``."""
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.envs.build import make_env as jmake_env
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu.utils import checkpoint as jck
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.controllers.functional import pid_controller
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo
from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_step
from simglucose_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    flatten_with_paths,
    restore_state,
    save_state,
)

# the envs packages export a function of that name
jro = importlib.import_module("simglucose_tpu.envs.rollout")
tro = importlib.import_module("simglucose_tpu_torch.envs.rollout")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "examples", "checkpoints")


def _leaves(tree):
    return [x for _, x in flatten_with_paths(tree)]


def _assert_same(a, b):
    """Every leaf of two trees bit for bit; generators by their state."""
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in flatten_with_paths(a)] == [p for p, _ in flatten_with_paths(b)]
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_save_restore_roundtrip(tmp_path):
    B = 4
    cfg, params = make_env(tables.cohort_names(B), batch=True, device="cpu")
    state, res = tro.batch_reset(cfg, params, env_keys(0, B, device="cpu"))
    p = str(tmp_path / "state.npz")
    save_state(p, (state, res))
    _assert_same((state, res), restore_state(p, (state, res)))


def test_resume_continues_identically(tmp_path):
    B, T = 4, 8
    cfg, params = make_env(tables.cohort_names(B), batch=True, device="cpu")
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, device="cpu")
    state, res = tro.batch_reset(cfg, params, env_keys(1, B, device="cpu"))
    ctrl_state = tro.broadcast_ctrl_state(ctrl0, B)
    run = tro.make_batch_rollout_fn(cfg, ctrl, n_steps=T)

    # straight through: 2T steps
    s1, last1, _ = run(params, state, ctrl_state, res)
    _, _, tr_cont = run(params, s1, ctrl_state, last1)

    # checkpointed: save after T, restore, continue
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(T, (s1, last1))
    s_r, last_r = mgr.restore(like=(s1, last1))
    _, _, tr2 = run(params, s_r, ctrl_state, last_r)
    assert torch.equal(tr_cont.BG, tr2.BG) and torch.equal(tr_cont.CGM, tr2.CGM)


def test_restore_casts_to_like_dtypes(tmp_path):
    """A float32 checkpoint restored against a float64 ``like`` comes back
    in ``like``'s dtypes (tensors and numpy arrays alike)."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": np.int32(7)}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    like = {"w": torch.zeros((2, 3), dtype=torch.float64), "n": np.int64(0)}
    out = restore_state(p, like)
    assert out["w"].dtype == torch.float64 and out["n"].dtype == np.int64 and int(out["n"]) == 7
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())


def test_restore_rejects_shape_mismatch(tmp_path):
    tree = {"w": torch.zeros((2, 3))}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    with pytest.raises(ValueError, match=r"leaf \['w'\] has shape \(2, 3\), expected \(4, 3\)"):
        restore_state(p, {"w": torch.zeros((4, 3))})
    with pytest.raises(ValueError, match="leaves"):
        restore_state(p, {"w": torch.zeros((2, 3)), "x": torch.zeros(2)})
    # a record's leaf is named by its path, as jax.tree_util.keystr writes it
    cfg = tppo.PPOConfig()
    pol = tpol.init_policy(torch.Generator().manual_seed(0), hidden=8, device="cpu")
    ts = init_fused_state(pol, tppo.make_optimizer(cfg).init(pol), 128, torch.Generator())
    save_state(p, ts)
    wide = tpol.init_policy(torch.Generator().manual_seed(0), hidden=16, device="cpu")
    with pytest.raises(ValueError, match=r"leaf \.params\.w1 has shape \(7, 8\), expected \(7, 16\)"):
        restore_state(p, ts._replace(params=wide))


def test_manager_rolling(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": torch.arange(3), "b": torch.tensor(1.5)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000000003.npz", "ckpt_000000000004.npz"]
    out = mgr.restore(like=tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"], tree["b"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like=tree)


def test_orbax_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(str(tmp_path), backend="orbax")


def test_generator_and_int_leaves_roundtrip(tmp_path):
    """A generator restores into a new generator in the saved state (its
    next draws are the original's); an int restores as an int."""
    g = torch.Generator().manual_seed(5)
    torch.randperm(100, generator=g)
    p = str(tmp_path / "g.npz")
    save_state(p, {"g": g, "n": 41})
    out = restore_state(p, {"g": torch.Generator(), "n": 0})
    assert out["g"] is not g and out["n"] == 41 and type(out["n"]) is int
    assert torch.equal(torch.randperm(100, generator=out["g"]), torch.randperm(100, generator=g))


def test_bfloat16_leaf_raises_on_save(tmp_path):
    with pytest.raises(TypeError, match=r"\['w'\] is bfloat16"):
        save_state(str(tmp_path / "b.npz"), {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_fused_ppo_resumes_bit_identically(tmp_path):
    """Fused PPO on the kernel_prep path (B=256, T=8, H=16): two
    iterations, each saved through a manager that keeps one file; the
    state restored into a fresh one of other params and another generator;
    one more iteration from the restored and from the original state gives
    the same bits in every leaf (params, Adam moments, the simulator
    planes, the generator's state) and the same metrics."""
    B, H = 256, 16
    cfg = tppo.PPOConfig(rollout_steps=8, epochs=2, minibatches=2, pallas_learner=True)
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    packed = tr.pack_params(p, basal_rate(p))
    opt = tppo.make_optimizer(cfg)

    def fresh(seed):
        pol = tpol.init_policy(torch.Generator().manual_seed(seed), hidden=H, act="relu",
                               init_mu_bias=-2.2, device="cpu")
        return init_fused_state(pol, opt.init(pol), B, torch.Generator().manual_seed(seed + 10))

    step = make_fused_train_step(cfg, B, hidden=H)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    ts = fresh(0)
    for it in (1, 2):
        ts, _ = step(packed, ts)
        mgr.save(it, ts)
    assert os.listdir(tmp_path) == ["ckpt_000000000002.npz"]
    restored = mgr.restore(like=fresh(1))
    assert restored.generator is not ts.generator and restored.opt_state.count == 8
    _assert_same(ts, restored)
    a, ma = step(packed, ts)
    b, mb = step(packed, restored)
    _assert_same(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_train_step_resumes_bit_identically(tmp_path):
    """``make_train_step`` (the eager env, B=8, T=4): a state saved after an
    iteration (its observation carries set) and restored into one of other
    params, keys and generator continues with the same bits."""
    B = 8
    cfg_e, env_params = make_env(tables.cohort_names(B), batch=True, random_init_bg=True,
                                 device="cpu")
    ppo_cfg = tppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    step = tppo.make_train_step(ppo_cfg, cfg_e)

    def after_one(seed):
        state, res = tro.batch_reset(cfg_e, env_params, env_keys(seed, B, device="cpu"))
        pol = tpol.init_policy(torch.Generator().manual_seed(seed), hidden=16, device="cpu")
        ts = tppo.TrainState(pol, tppo.make_optimizer(ppo_cfg).init(pol), state, res,
                             env_keys((seed, 1), B, device="cpu"),
                             torch.Generator().manual_seed(seed + 2))
        return step(env_params, ts)[0]

    ts = after_one(0)
    assert ts.cgm_prev is not None and ts.step == 4
    p = str(tmp_path / "ts.npz")
    save_state(p, ts)
    restored = restore_state(p, after_one(7))
    _assert_same(ts, restored)
    a, ma = step(env_params, ts)
    b, mb = step(env_params, restored)
    _assert_same(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_policy_params_interchange_with_jax(tmp_path):
    """A PolicyParams saved by the port restores in the JAX package's
    restore_state bit for bit, and the other way round."""
    H = 16
    port = tpol.init_policy(torch.Generator().manual_seed(3), hidden=H, act="relu", device="cpu")
    jlike = jpol.init_policy(jax.random.PRNGKey(0), hidden=H, act="relu")
    p = str(tmp_path / "port.npz")
    save_state(p, port)
    got = jck.restore_state(p, jlike)
    for a, b in zip(jax.tree_util.tree_leaves(got), port.leaves()):
        assert np.asarray(a).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    jparams = jpol.init_policy(jax.random.PRNGKey(4), hidden=H, act="relu")
    q = str(tmp_path / "jax.npz")
    jck.save_state(q, jparams)
    got = restore_state(q, port)
    assert got.act == "relu"
    for a, b in zip(jax.tree_util.tree_leaves(jparams), got.leaves()):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name,meta", [
    ("ppo_cohort_relu64.npz", dict(act="relu", action_scale=10.0, scale_by_basal=True)),
    ("ppo_cohort_residual_bb.npz", dict(act="relu", action_scale=1.1, decoder="residual_bb")),
])
def test_example_checkpoints_restore_as_load_policy_npz(name, meta):
    like = tpol.init_policy(torch.Generator().manual_seed(0), hidden=64, device="cpu", **meta)
    got = restore_state(os.path.join(CKPT, name), like)
    want = tpol.load_policy_npz(os.path.join(CKPT, name), device="cpu", **meta)
    assert got == got.replace() and (got.act, got.decoder) == (want.act, want.decoder)
    for a, b in zip(got.leaves(), want.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_jax_train_state_does_not_restore_into_the_port(tmp_path):
    """JAX's threefry key and optax state are other leaves than the port's
    Philox key and AdamState: restore_state says so."""
    B, H = 8, 16
    jcfg, jparams_env = jmake_env(tables.cohort_names(B), batch=True, dtype=np.float32)
    jstate, jres = jro.batch_reset(jcfg, jparams_env, jax.random.split(jax.random.PRNGKey(0), B))
    jp = jpol.init_policy(jax.random.PRNGKey(1), hidden=H)
    jts = jppo.TrainState(jp, jppo.make_optimizer(jppo.PPOConfig()).init(jp), jstate, jres,
                          jax.random.PRNGKey(2))
    p = str(tmp_path / "jts.npz")
    jck.save_state(p, jts)

    cfg_e, env_params = make_env(tables.cohort_names(B), batch=True, device="cpu")
    state, res = tro.batch_reset(cfg_e, env_params, env_keys(0, B, device="cpu"))
    pol = tpol.init_policy(torch.Generator().manual_seed(1), hidden=H, device="cpu")
    ts = tppo.TrainState(pol, tppo.make_optimizer(tppo.PPOConfig()).init(pol), state, res,
                         env_keys((0, 1), B, device="cpu"), torch.Generator())
    with pytest.raises(ValueError, match="leaves|shape"):
        restore_state(p, ts)
