"""The port's data-parallel learners and mesh trainers on two gloo ranks on
the CPU, against the JAX package and the one-process port.

One spawn of two ranks (tests/test_torch_multidevice_sim.py's
``spawn_ranks``) runs every case and writes an npz per rank:

* ``_update`` under a mesh with the 'step' learner (``_update_dp``: K4's
  plain version per rank, one all-reduce of the statistics and one per
  minibatch), float32 and bfloat16, against JAX's ``_update_pallas_dp`` on
  a 2-device mesh in interpret mode with the same per-epoch permutations of
  each rank's blocks (JAX's key splits, replayed), from an optimizer state
  one Adam step in: tests/test_torch_plane.py's TOL_PARAMS / TOL_NU /
  TOL_AUX at both dtypes (the bf16 rows' products are the same bfloat16
  products summed in another order: tests/test_torch_learner_bf16.py's
  contract, here at H=16);
* the autograd learner under a mesh (False and 'epoch', which a mesh runs
  as autograd, as JAX does) against the one-process autograd learner at the
  same permutations of the global blocks: rtol 1e-5 / atol 1e-6 (float32,
  only the order of the sums differs);
* ``make_train_step(mesh=)`` with the autograd learner against the
  one-process ``make_train_step`` on the same global batch: the rollout
  (env state, last result, carries) bit for bit, the params and Adam's
  moments within rtol 1e-5 / atol 1e-6;
* ``make_fused_train_step(mesh=)``: with the autograd learner, one
  iteration against the one-process observation-plane path (the rollout's
  state bit for bit, the params as above); with 'step', two iterations;
* ``replicate`` and ``gather_to_host`` on the live group.

Every update leaves the two ranks' params bit-identical.
``dryrun_multichip(2, device="cpu")`` spawns its own two ranks.
"""
import dataclasses
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.parallel.sharding import make_mesh as jmake_mesh
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch.parallel.dryrun import dryrun_multichip
from simglucose_tpu_torch.rl import fused as tfused
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

from test_torch_multidevice_sim import N_RANKS, spawn_ranks
from test_torch_plane import TOL_AUX, TOL_NU, TOL_PARAMS, _jax_and_port_policy

torch.set_num_threads(1)

T, B = 8, 128  # the learner's transition: 64 lanes a rank, 2-row shuffle blocks
TOL_DP = dict(rtol=1e-5, atol=1e-6)
TRAIN = dict(B=64, T=8, H=16)  # make_train_step: 32 lanes a rank
FUSED = dict(B=256, T=8, H=16)
CFG_KW = dict(epochs=2, minibatches=2, lr=1e-3)

HELPERS = """
import torch
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.envs.build import cohort_names, make_env
from simglucose_tpu_torch.envs.rollout import batch_reset
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.rl import fused as tfused, policy as tpol, ppo as tppo


def train_setup(ppo_cfg, shape, adam, params_like):
    '''The one-process ``make_train_step`` arguments on the global batch:
    env, reset, policy (the npz arrays ``p_*``), ``adam`` and a generator.'''
    Bg = shape["B"]
    env_cfg, env_params = make_env(cohort_names(Bg), batch=True, random_init_bg=True,
                                   device="cpu")
    env_state, reset = batch_reset(env_cfg, env_params, env_keys((3, 4), Bg, device="cpu"))
    arrs = [params_like["p_" + k] for k in tpol.LEAVES]
    params = tpol.policy_from_numpy(arrs, act="relu", device="cpu")
    ts = tppo.TrainState(params=params, opt_state=adam, env_state=env_state, prev_res=reset,
                         key=env_keys((5, 6), Bg, device="cpu"),
                         generator=torch.Generator().manual_seed(9))
    return env_cfg, env_params, ppo_cfg, ts


def fused_setup(shape, learner, mesh=None):
    '''(config, global packed planes, fresh state) of the fused plane path.'''
    cfg = tppo.PPOConfig(rollout_steps=shape["T"], epochs=2, minibatches=2, lr=1e-3,
                         pallas_learner=learner, action_scale=10.0, scale_by_basal=True)
    names = tables.cohort_names(shape["B"])
    p = tables.load_patient_params(names, device="cpu")
    packed = tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))
    params = tpol.init_policy(torch.Generator().manual_seed(4), hidden=shape["H"], act="relu",
                              init_mu_bias=-1.0, action_scale=10.0, scale_by_basal=True,
                              device="cpu")
    ts = tfused.init_fused_state(params, tppo.make_optimizer(cfg).init(params), shape["B"],
                                 torch.Generator().manual_seed(8), mesh=mesh)
    return cfg, packed, ts
"""
# the ranks run the same setup code (the workers import no JAX)
exec(HELPERS)

WORKER = """
import dataclasses, json, os, sys
import numpy as np, torch
rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from simglucose_tpu_torch.parallel.multihost import process_group
# every rank leaves the group with the others (a barrier, then
# destroy_process_group): a rank that exits while the other is in its last
# collective aborts in gloo's teardown
with process_group(f"file://{store}", world_size=n, rank=rank, backend="gloo"):
    from simglucose_tpu_torch.parallel.sharding import gather_to_host, make_mesh, replicate, shard_batch
    from simglucose_tpu_torch.rl import fused as tfused, policy as tpol, ppo as tppo

    spec = json.load(open(os.path.join(workdir, "spec.json")))
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    mesh = make_mesh()
    res = {}
    # setup code
    t = lambda k: torch.from_numpy(inp[k])
    params = tpol.policy_from_numpy([inp["p_" + k] for k in tpol.LEAVES], act="relu", device="cpu")
    adam = tppo.AdamState(int(inp["adam_count"]), t("adam_mu"), t("adam_nu"))

    def flat(p):
        return tppo.flatten_params(p).numpy()

    # the learners over a sharded transition
    traj = tppo.Transition(*(shard_batch(t(k), mesh, axis=1) for k in
                             ("obs", "raw", "logp", "value", "reward", "done")))
    advs, rets = shard_batch(t("advs"), mesh, axis=1), shard_batch(t("rets"), mesh, axis=1)
    for name, kw, perms in (("step", dict(pallas_learner="step"), inp["perms_local"]),
                            ("step_bf16", dict(pallas_learner="step", learner_bf16=True),
                             inp["perms_local"]),
                            ("autograd", dict(pallas_learner=False), inp["perms_global"]),
                            ("epoch", dict(pallas_learner="epoch"), inp["perms_global"])):
        cfg = tppo.PPOConfig(**spec["cfg"], **kw)
        p2, s2, aux = tppo._update(cfg, tppo.make_optimizer(cfg), params, adam, traj, advs, rets,
                                   perms=list(perms), mesh=mesh)
        res[name + "_params"], res[name + "_mu"], res[name + "_nu"] = flat(p2), s2.mu.numpy(), s2.nu.numpy()
        res[name + "_count"] = s2.count
        res[name + "_aux"] = torch.stack(aux).numpy()

    # make_train_step on the sharded env
    env_cfg, env_params, ppo_cfg, ts = train_setup(tppo.PPOConfig(**spec["cfg"], rollout_steps=spec["train"]["T"]),
                                                   spec["train"], adam, params_like=inp)
    ts = ts._replace(env_state=shard_batch(ts.env_state, mesh), prev_res=shard_batch(ts.prev_res, mesh),
                     key=shard_batch(ts.key, mesh), params=replicate(ts.params, mesh),
                     opt_state=replicate(ts.opt_state, mesh), generator=replicate(ts.generator, mesh))
    ts2, m = tppo.make_train_step(ppo_cfg, env_cfg, mesh=mesh)(shard_batch(env_params, mesh), ts)
    res["train_params"], res["train_mu"] = flat(ts2.params), ts2.opt_state.mu.numpy()
    res["train_BG"] = ts2.prev_res.BG.numpy()
    res["train_cgm_prev"], res["train_iob"] = ts2.cgm_prev.numpy(), ts2.iob.numpy()
    res["train_x"] = ts2.env_state.patient.x.numpy()
    res["train_metrics"] = np.array([float(m[k]) for k in sorted(m)])

    # the fused mesh trainer on the observation-plane path
    for learner, iters in ((False, 1), ("step", 2)):
        cfg, packed, fts = fused_setup(spec["fused"], learner, mesh=mesh)
        step = tfused.make_fused_train_step(cfg, spec["fused"]["B"], hidden=spec["fused"]["H"], mesh=mesh)
        for i in range(iters):
            fts, fm = step(packed, fts)
            res[f"fused_{learner}_{i}_params"] = flat(fts.params)
            res[f"fused_{learner}_{i}_state_f"] = fts.state_f.numpy()
            res[f"fused_{learner}_{i}_metrics"] = np.array([float(fm[k]) for k in sorted(fm)])

    # replicate / gather_to_host on the live group
    mine = torch.full((3, 2), float(rank + 1))
    g = torch.Generator().manual_seed(100 + rank)
    rep = replicate({"x": mine, "g": g}, mesh)
    res["replicated"] = rep["x"].numpy()
    res["replicated_draw"] = torch.rand(4, generator=rep["g"]).numpy()
    res["gathered"] = gather_to_host({"x": mine}, mesh)["x"]
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
"""
WORKER = WORKER.replace("    # setup code\n", textwrap.indent(HELPERS, "    "))


def _transition(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda loc, scale, shape=(T, B): rng.normal(loc, scale, shape).astype(np.float32)
    return dict(obs=f(0, 1, (T, B, 7)), raw=f(-1, 1), logp=f(-1.2, 0.3), value=f(0, 2),
                reward=f(0, 1), done=np.zeros((T, B), np.float32), advs=f(0.3, 1),
                rets=f(0, 2))


def _perms(n_blocks, epochs=2):
    """JAX's per-epoch permutations (its key splits from PRNGKey(11))."""
    out, k = [], jax.random.PRNGKey(11)
    for _ in range(epochs):
        k, k_perm = jax.random.split(k)
        out.append(np.asarray(jax.random.permutation(k_perm, n_blocks)))
    return np.stack(out)


def _jax_state(jp, jcfg):
    """JAX's optimizer state one Adam step in (count 1, mu and nu not 0)."""
    jopt = jppo.make_optimizer(jcfg)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32), jp)
    return jopt, jopt.update(g, jopt.init(jp), jp)[1]


@pytest.fixture(scope="module")
def setup():
    jp, tp = _jax_and_port_policy()
    jcfg = jppo.PPOConfig(**CFG_KW)
    jopt, jstate = _jax_state(jp, jcfg)
    adam = tppo.opt_state_from_optax(jstate, device="cpu")
    bs_l, n_local, _ = tppo._shuffle_blocking(tppo.PPOConfig(**CFG_KW), T * B // N_RANKS)
    _, n_global, _ = tppo._shuffle_blocking(tppo.PPOConfig(**CFG_KW), T * B)
    return dict(jp=jp, tp=tp, jopt=jopt, jstate=jstate, adam=adam, arrays=_transition(),
                perms_local=_perms(n_local), perms_global=_perms(n_global))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice_learner")
    spec = dict(cfg=CFG_KW, train=TRAIN, fused=FUSED)
    with open(d / "spec.json", "w") as f:
        json.dump(spec, f)
    a = setup["adam"]
    np.savez(d / "inputs.npz", **setup["arrays"], perms_local=setup["perms_local"],
             perms_global=setup["perms_global"], adam_count=a.count, adam_mu=a.mu.numpy(),
             adam_nu=a.nu.numpy(),
             **{"p_" + k: v.numpy() for k, v in zip(tpol.LEAVES, setup["tp"].leaves())})
    return spawn_ranks(WORKER, d)


def _ranks_equal(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("bf16", [False, True])
def test_update_dp_matches_jax_update_pallas_dp(setup, ranks, bf16):
    """The 'step' learner under a 2-rank mesh against JAX's K4 learner on a
    2-device mesh (interpret mode): params, Adam's count/mu/nu and the aux;
    the two ranks' params, mu and nu bit-identical."""
    name = "step_bf16" if bf16 else "step"
    jcfg = jppo.PPOConfig(**CFG_KW, pallas_learner="step", learner_bf16=bf16)
    mesh = jmake_mesh(dp=N_RANKS, tp=1, devices=jax.devices()[:N_RANKS])
    a = setup["arrays"]
    jtr = jppo.Transition(*(jnp.asarray(a[k]) for k in ("obs", "raw", "logp", "value", "reward",
                                                        "done")))
    jp2, jstate2, _, jaux = jppo._update(jcfg, setup["jopt"], setup["jp"], setup["jstate"], jtr,
                                         jnp.asarray(a["advs"]), jnp.asarray(a["rets"]),
                                         jax.random.PRNGKey(11), mesh, interpret=True)
    jflat = np.concatenate([np.asarray(getattr(jp2, k)).reshape(-1) for k in tpol.LEAVES])
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    for k in ("_params", "_mu", "_nu"):
        _ranks_equal(ranks, name + k)
    r = ranks[0]
    np.testing.assert_allclose(r[name + "_params"], jflat, **TOL_PARAMS)
    assert np.abs(r[name + "_params"] - tppo.flatten_params(setup["tp"]).numpy()).max() > 1e-3
    assert int(r[name + "_count"]) == jadam.count == 1 + 4
    np.testing.assert_allclose(r[name + "_mu"], jadam.mu.numpy(), **TOL_PARAMS)
    np.testing.assert_allclose(r[name + "_nu"], jadam.nu.numpy(), **TOL_NU)
    np.testing.assert_allclose(r[name + "_aux"], np.stack([np.asarray(x) for x in jaux]),
                               **TOL_AUX)
    if bf16:  # the bf16 learner is not the f32 one
        assert np.abs(r["step_bf16_params"] - r["step_params"]).max() > 1e-6


def test_dp_autograd_learner_equals_one_process(setup, ranks):
    """The autograd learner (False, and 'epoch', which a mesh runs as
    autograd) on two ranks against the one-process autograd learner on the
    gathered batch at the same permutations of the global blocks."""
    cfg = tppo.PPOConfig(**CFG_KW, pallas_learner=False)
    a = {k: torch.from_numpy(v) for k, v in setup["arrays"].items()}
    traj = tppo.Transition(a["obs"], a["raw"], a["logp"], a["value"], a["reward"], a["done"])
    p2, s2, aux = tppo._update(cfg, tppo.make_optimizer(cfg), setup["tp"], setup["adam"], traj,
                               a["advs"], a["rets"], perms=list(setup["perms_global"]))
    for k in ("_params", "_mu", "_nu", "_aux"):
        _ranks_equal(ranks, "autograd" + k)
        np.testing.assert_array_equal(ranks[0]["epoch" + k], ranks[0]["autograd" + k])
    r = ranks[0]
    np.testing.assert_allclose(r["autograd_params"], tppo.flatten_params(p2).numpy(), **TOL_DP)
    np.testing.assert_allclose(r["autograd_mu"], s2.mu.numpy(), **TOL_DP)
    np.testing.assert_allclose(r["autograd_nu"], s2.nu.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(r["autograd_aux"], torch.stack(aux).numpy(), **TOL_DP)


def test_mesh_make_train_step_equals_one_process(setup, ranks):
    """``make_train_step(mesh=)`` with the autograd learner: each rank's
    rollout is its lanes of the one-process rollout bit for bit, and the
    params and Adam's mu match the one-process step."""
    inp = {"p_" + k: v.numpy() for k, v in zip(tpol.LEAVES, setup["tp"].leaves())}
    cfg = tppo.PPOConfig(**CFG_KW, rollout_steps=TRAIN["T"])
    env_cfg, env_params, ppo_cfg, ts = train_setup(cfg, TRAIN, setup["adam"], inp)
    ts2, m = tppo.make_train_step(ppo_cfg, env_cfg)(env_params, ts)
    got = lambda k: np.concatenate([r[k] for r in ranks], axis=0)
    np.testing.assert_array_equal(got("train_BG"), ts2.prev_res.BG.numpy())
    np.testing.assert_array_equal(got("train_cgm_prev"), ts2.cgm_prev.numpy())
    np.testing.assert_array_equal(got("train_iob"), ts2.iob.numpy())
    np.testing.assert_array_equal(got("train_x"), ts2.env_state.patient.x.numpy())
    for k in ("train_params", "train_mu", "train_metrics"):
        _ranks_equal(ranks, k)
    r = ranks[0]
    np.testing.assert_allclose(r["train_params"], tppo.flatten_params(ts2.params).numpy(),
                               **TOL_DP)
    np.testing.assert_allclose(r["train_mu"], ts2.opt_state.mu.numpy(), **TOL_DP)
    np.testing.assert_allclose(r["train_metrics"], [float(m[k]) for k in sorted(m)], **TOL_DP)


def test_mesh_fused_train_step(ranks):
    """The fused trainer under a mesh: with the autograd learner its first
    iteration equals the one-process observation-plane path (the carried
    simulator state bit for bit, the params within TOL_DP); with 'step',
    two iterations with finite metrics and the ranks' params identical."""
    cfg, packed, ts = fused_setup(FUSED, False)
    ts2, m = tfused.make_fused_train_step(cfg, FUSED["B"], hidden=FUSED["H"],
                                          kernel_prep=False)(packed, ts)
    state_f = np.concatenate([r["fused_False_0_state_f"] for r in ranks], axis=1)
    np.testing.assert_array_equal(state_f, ts2.state_f.numpy())
    np.testing.assert_allclose(ranks[0]["fused_False_0_params"],
                               tppo.flatten_params(ts2.params).numpy(), **TOL_DP)
    np.testing.assert_allclose(ranks[0]["fused_False_0_metrics"], [float(m[k]) for k in sorted(m)],
                               **TOL_DP)
    for i in range(2):
        _ranks_equal(ranks, f"fused_step_{i}_params")
        assert np.isfinite(ranks[0][f"fused_step_{i}_metrics"]).all()
    assert not np.array_equal(ranks[0]["fused_step_0_params"], ranks[0]["fused_step_1_params"])


def test_replicate_and_gather_to_host(ranks):
    """``replicate``: every rank holds rank 0's tensor and generator state;
    ``gather_to_host``: the ranks' rows in rank order, on every rank."""
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], np.full((3, 2), 1.0, np.float32))
        np.testing.assert_array_equal(
            r["replicated_draw"], torch.rand(4, generator=torch.Generator().manual_seed(100)))
        np.testing.assert_array_equal(r["gathered"], np.repeat([[1.0], [2.0]], 3, 0).repeat(2, 1))


def test_dryrun_multichip_two_ranks():
    """The dry run spawns two gloo ranks on the CPU (``device="cpu"``: the
    default is the card): one ``make_train_step(mesh=)`` iteration on the
    ``(1, 2)`` mesh and on ``(2, 1)`` with the same inputs, finite reward,
    params bit-identical across ranks and the two meshes' params within the
    JAX tolerance."""
    dryrun_multichip(2, device="cpu")
