"""Tensor parallelism: the policy's hidden dimension split over the ``tp``
axis of a ``(dp, tp)`` mesh of four gloo ranks on the CPU, against the
one-process port and the JAX package.

One spawn of four ranks (tests/test_torch_multidevice_sim.py's
``spawn_ranks``) builds the meshes ``(4, 1)``, ``(2, 2)`` and ``(1, 4)`` over
the same ranks, runs every case and writes an npz per rank:

* (a) ``policy_apply`` under each mesh, each rank on its ``dp`` shard of
  128 rows (H=16, relu), at float32 and bfloat16: mu, value and the
  gradients of every leaf and of the observations.  At ``tp == 1`` the
  one-process function bit for bit; under ``tp > 1`` float32 within
  rtol 1e-5 / atol 1e-6 (``TOL_DP``: only the order of layer 2's sums
  differs) and bfloat16 within tests/test_torch_learner_bf16.py's
  ``TOL_BF16`` of each array's largest magnitude (a sum an ulp apart may
  round to the other bfloat16 neighbour);
* (b) ``_update`` under ``(2, 2)`` and ``(1, 4)``: every ``pallas_learner``
  value runs the autograd learner (bit for bit the same), within
  ``TOL_DP`` of the one-process autograd learner at the same permutations
  of the global blocks;
* (c) the ``(2, 2)`` learner against JAX's ``_update`` on a ``(2, 2)``
  device mesh (its XLA learner under GSPMD) at the JAX key chain's
  permutations: tests/test_torch_plane.py's ``TOL_PARAMS`` / ``TOL_NU`` /
  ``TOL_AUX``;
* (d) ``make_train_step(mesh=(2, 2))`` (B=64, T=8) and (e)
  ``make_fused_train_step`` under ``(2, 2)`` (B=256, T=8, K1b's plain
  version, the 'step' learner, which ``tp`` runs as autograd), against one
  process on the same global batch: the params within JAX's dry-run
  tolerance (rtol 2e-5, atol 1e-6); in (e) the rollout's simulator state
  bit for bit, since K1b runs the whole MLP on each rank.  (d)'s rollout
  samples from the split policy, whose raw actions move by ulps: its env
  state is held by tolerance;
* (f) after every update the four ranks' params are bit-identical, and so
  is each ``tp`` group's env state.

(g) ``dryrun_multichip(4, device="cpu")`` spawns its own four ranks.  The
other tests need no group: ``param_specs`` against JAX's, the rank's
coordinates against ``jmake_mesh(dp, tp).devices``, the process group each
axis reduces over, and the dry run's refusal of a missing card.
"""
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from simglucose_tpu.parallel.sharding import make_mesh as jmake_mesh
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch.parallel import sharding
from simglucose_tpu_torch.parallel.dryrun import dryrun_multichip
from simglucose_tpu_torch.parallel.sharding import Mesh
from simglucose_tpu_torch.rl import fused as tfused
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

from test_torch_learner_bf16 import TOL_BF16
from test_torch_multidevice_learner import (
    CFG_KW,
    HELPERS,
    TOL_DP,
    _jax_state,
    _perms,
    _transition,
    fused_setup,
    train_setup,
)
from test_torch_multidevice_sim import spawn_ranks
from test_torch_plane import TOL_AUX, TOL_NU, TOL_PARAMS, _jax_and_port_policy

torch.set_num_threads(1)

N_RANKS = 4
AXES = sharding.AXES
MESHES = {"dp4": (4, 1), "tp2": (2, 2), "tp4": (1, 4)}
TP_MESHES = ("tp2", "tp4")
LEARNERS = {"autograd": False, "true": True, "step": "step", "epoch": "epoch"}
TRAIN = dict(B=64, T=8, H=16)
FUSED = dict(B=256, T=8, H=16)
TOL_TP = dict(rtol=2e-5, atol=1e-6)  # __graft_entry__.py::dryrun_multichip's tp=2 vs tp=1
APPLY_ROWS = 128

WORKER = """
import json, os, sys
import numpy as np, torch
rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from simglucose_tpu_torch.parallel.multihost import process_group
# every rank leaves the group with the others (a barrier, then
# destroy_process_group)
with process_group(f"file://{store}", world_size=n, rank=rank, backend="gloo"):
    from simglucose_tpu_torch.parallel.sharding import make_mesh, replicate, shard_batch
    from simglucose_tpu_torch.rl import fused as tfused, policy as tpol, ppo as tppo

    spec = json.load(open(os.path.join(workdir, "spec.json")))
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    # setup code
    t = lambda k: torch.from_numpy(inp[k])
    flat = lambda p: tppo.flatten_params(p).numpy()
    params = tpol.policy_from_numpy([inp["p_" + k] for k in tpol.LEAVES], act="relu", device="cpu")
    adam = tppo.AdamState(int(inp["adam_count"]), t("adam_mu"), t("adam_nu"))
    # every rank builds the meshes in the same order (a 2-D one makes its sub-groups)
    meshes = {name: make_mesh(dp=dp, tp=tp) for name, (dp, tp) in spec["meshes"].items()}
    res = {}
    for name, mesh in meshes.items():
        res[name + "_coords"] = np.array([mesh.dp_rank, mesh.tp_rank])
        # (a) the forward and every leaf's and the observations' gradient
        for dt, cdt in (("f32", None), ("bf16", torch.bfloat16)):
            obs = shard_batch(t("apply_obs"), mesh).clone().requires_grad_(True)
            coef = shard_batch(t("apply_coef"), mesh)
            leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
            mu, log_std, v = tpol.policy_apply(params.replace(**dict(zip(tpol.LEAVES, leaves))),
                                               obs, compute_dtype=cdt, mesh=mesh)
            loss = (mu * coef[:, 0]).sum() + (v * coef[:, 1]).sum() + log_std
            grads = torch.autograd.grad(loss, leaves + [obs])
            key = f"{name}_apply_{dt}"
            res[key + "_mu"], res[key + "_v"] = mu.detach().numpy(), v.detach().numpy()
            for leaf, g in zip(tpol.LEAVES + ("obs",), grads):
                res[f"{key}_d{leaf}"] = g.numpy()
        if mesh.tp == 1:
            continue
        # (b) _update under the mesh with each pallas_learner value
        traj = tppo.Transition(*(shard_batch(t(k), mesh, axis=1) for k in
                                 ("obs", "raw", "logp", "value", "reward", "done")))
        advs, rets = shard_batch(t("advs"), mesh, axis=1), shard_batch(t("rets"), mesh, axis=1)
        for lname, learner in spec["learners"].items():
            cfg = tppo.PPOConfig(**spec["cfg"], pallas_learner=learner)
            p2, s2, aux = tppo._update(cfg, tppo.make_optimizer(cfg), params, adam, traj, advs,
                                       rets, perms=list(inp["perms_global"]), mesh=mesh)
            key = f"{name}_{lname}"
            res[key + "_params"], res[key + "_mu"], res[key + "_nu"] = flat(p2), s2.mu.numpy(), s2.nu.numpy()
            res[key + "_count"] = s2.count
            res[key + "_aux"] = torch.stack(aux).numpy()

    mesh = meshes["tp2"]
    # (d) make_train_step on the (2, 2) mesh
    env_cfg, env_params, ppo_cfg, ts = train_setup(
        tppo.PPOConfig(**spec["cfg"], rollout_steps=spec["train"]["T"]), spec["train"], adam,
        params_like=inp)
    ts = ts._replace(env_state=shard_batch(ts.env_state, mesh), prev_res=shard_batch(ts.prev_res, mesh),
                     key=shard_batch(ts.key, mesh), params=replicate(ts.params, mesh),
                     opt_state=replicate(ts.opt_state, mesh), generator=replicate(ts.generator, mesh))
    ts2, m = tppo.make_train_step(ppo_cfg, env_cfg, mesh=mesh)(shard_batch(env_params, mesh), ts)
    res["train_params"], res["train_mu"] = flat(ts2.params), ts2.opt_state.mu.numpy()
    res["train_BG"] = ts2.prev_res.BG.numpy()
    res["train_cgm_prev"], res["train_iob"] = ts2.cgm_prev.numpy(), ts2.iob.numpy()
    res["train_x"] = ts2.env_state.patient.x.numpy()
    res["train_metrics"] = np.array([float(m[k]) for k in sorted(m)])

    # (e) the fused mesh trainer, two iterations on the (2, 2) mesh
    cfg, packed, fts = fused_setup(spec["fused"], "step", mesh=mesh)
    step = tfused.make_fused_train_step(cfg, spec["fused"]["B"], hidden=spec["fused"]["H"], mesh=mesh)
    for i in range(2):
        fts, fm = step(packed, fts)
        res[f"fused_{i}_params"] = flat(fts.params)
        res[f"fused_{i}_state_f"], res[f"fused_{i}_state_i"] = fts.state_f.numpy(), fts.state_i.numpy()
        res[f"fused_{i}_metrics"] = np.array([float(fm[k]) for k in sorted(fm)])
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
"""
WORKER = WORKER.replace("    # setup code\n", textwrap.indent(HELPERS, "    "))


@pytest.fixture(scope="module")
def setup():
    jp, tp = _jax_and_port_policy()
    jcfg = jppo.PPOConfig(**CFG_KW)
    jopt, jstate = _jax_state(jp, jcfg)
    adam = tppo.opt_state_from_optax(jstate, device="cpu")
    arrays = _transition()
    _, n_global, _ = tppo._shuffle_blocking(tppo.PPOConfig(**CFG_KW), arrays["reward"].size)
    rng = np.random.default_rng(7)
    apply = dict(apply_obs=rng.normal(0, 1, (APPLY_ROWS, 7)).astype(np.float32),
                 apply_coef=rng.normal(0, 1, (APPLY_ROWS, 2)).astype(np.float32))
    return dict(jp=jp, tp=tp, jopt=jopt, jstate=jstate, adam=adam, arrays=arrays,
                perms_global=_perms(n_global), **apply)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice_tp")
    spec = dict(cfg=CFG_KW, train=TRAIN, fused=FUSED, meshes=MESHES, learners=LEARNERS)
    with open(d / "spec.json", "w") as f:
        json.dump(spec, f)
    a = setup["adam"]
    np.savez(d / "inputs.npz", **setup["arrays"], perms_global=setup["perms_global"],
             apply_obs=setup["apply_obs"], apply_coef=setup["apply_coef"], adam_count=a.count,
             adam_mu=a.mu.numpy(), adam_nu=a.nu.numpy(),
             **{"p_" + k: v.numpy() for k, v in zip(tpol.LEAVES, setup["tp"].leaves())})
    return spawn_ranks(WORKER, d, n=N_RANKS)


def _ranks_equal(ranks, key, which=None):
    """``key`` bit-identical on the ranks ``which`` (default all)."""
    which = range(len(ranks)) if which is None else which
    first, *rest = which
    for r in rest:
        np.testing.assert_array_equal(ranks[r][key], ranks[first][key], err_msg=f"{key} rank {r}")


def _tp_groups(name):
    dp, tp = MESHES[name]
    return [list(range(d * tp, (d + 1) * tp)) for d in range(dp)]


def _one_process_apply(params, obs, coef, cdt):
    """policy_apply in one process on ``obs``: mu, v and each gradient."""
    obs = torch.from_numpy(obs).requires_grad_(True)
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    mu, log_std, v = tpol.policy_apply(params.replace(**dict(zip(tpol.LEAVES, leaves))), obs,
                                       compute_dtype=cdt)
    coef = torch.from_numpy(coef)
    loss = (mu * coef[:, 0]).sum() + (v * coef[:, 1]).sum() + log_std
    grads = torch.autograd.grad(loss, leaves + [obs])
    out = dict(mu=mu.detach().numpy(), v=v.detach().numpy())
    out.update({"d" + k: g.numpy() for k, g in zip(tpol.LEAVES + ("obs",), grads)})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_policy_apply_and_gradients_match_one_process(setup, ranks, mesh, dt):
    """(a) Each rank's forward and full-leaf gradients on its dp shard
    against one process on the same rows; the ranks of a tp group agree
    bit for bit, and every leaf's gradient is counted once (``log_std``'s
    is exactly 1 + 0 here, not ``tp``)."""
    dp, tp = MESHES[mesh]
    cdt = torch.bfloat16 if dt == "bf16" else None
    per = APPLY_ROWS // dp
    outs = ["mu", "v"] + ["d" + k for k in tpol.LEAVES + ("obs",)]
    for r, got in enumerate(ranks):
        d, k = (int(x) for x in got[mesh + "_coords"])
        assert (d, k) == (r // tp, r % tp)
        rows = slice(d * per, (d + 1) * per)
        ref = _one_process_apply(setup["tp"], setup["apply_obs"][rows],
                                 setup["apply_coef"][rows], cdt)
        for o in outs:
            g, w = got[f"{mesh}_apply_{dt}_{o}"], ref[o]
            if tp == 1:
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {o}")
            elif dt == "f32":
                np.testing.assert_allclose(g, w, err_msg=f"rank {r} {o}", **TOL_DP)
            else:
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= TOL_BF16, (r, o, err)
        assert float(got[f"{mesh}_apply_{dt}_dlog_std"][0]) == float(ref["dlog_std"][0])
    for group in _tp_groups(mesh):
        for o in outs:
            _ranks_equal(ranks, f"{mesh}_apply_{dt}_{o}", group)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_update_equals_one_process_autograd(setup, ranks, mesh):
    """(b) Under tp > 1 every pallas_learner value is the autograd learner,
    bit for bit, within TOL_DP of the one-process autograd learner at the
    same permutations of the global blocks; (f) every rank ends each
    update with the same params and Adam moments, bit for bit."""
    cfg = tppo.PPOConfig(**CFG_KW, pallas_learner=False)
    a = {k: torch.from_numpy(v) for k, v in setup["arrays"].items()}
    traj = tppo.Transition(a["obs"], a["raw"], a["logp"], a["value"], a["reward"], a["done"])
    p2, s2, aux = tppo._update(cfg, tppo.make_optimizer(cfg), setup["tp"], setup["adam"], traj,
                               a["advs"], a["rets"], perms=list(setup["perms_global"]))
    for lname in LEARNERS:
        for k in ("_params", "_mu", "_nu", "_aux"):
            _ranks_equal(ranks, f"{mesh}_{lname}{k}")
            np.testing.assert_array_equal(ranks[0][f"{mesh}_{lname}{k}"],
                                          ranks[0][f"{mesh}_autograd{k}"], err_msg=lname)
    r = ranks[0]
    assert int(r[f"{mesh}_autograd_count"]) == s2.count
    np.testing.assert_allclose(r[f"{mesh}_autograd_params"], tppo.flatten_params(p2).numpy(),
                               **TOL_DP)
    np.testing.assert_allclose(r[f"{mesh}_autograd_mu"], s2.mu.numpy(), **TOL_DP)
    np.testing.assert_allclose(r[f"{mesh}_autograd_nu"], s2.nu.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(r[f"{mesh}_autograd_aux"], torch.stack(aux).numpy(), **TOL_DP)


def test_tp_update_matches_jax_update_on_a_2x2_mesh(setup, ranks):
    """(c) The port's learner under (2, 2) against JAX's ``_update`` on a
    ``(dp=2, tp=2)`` device mesh (its XLA learner: jax.grad of the loss
    with the first layer constrained to ``P('dp', 'tp')``) at the JAX key
    chain's permutations."""
    jcfg = jppo.PPOConfig(**CFG_KW, pallas_learner=False)
    mesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    a = setup["arrays"]
    jtr = jppo.Transition(*(jnp.asarray(a[k]) for k in ("obs", "raw", "logp", "value", "reward",
                                                        "done")))
    update = jax.jit(lambda *args: jppo._update(jcfg, setup["jopt"], *args, mesh))
    jp2, jstate2, _, jaux = update(setup["jp"], setup["jstate"], jtr, jnp.asarray(a["advs"]),
                                   jnp.asarray(a["rets"]), jax.random.PRNGKey(11))
    jflat = np.concatenate([np.asarray(getattr(jp2, k)).reshape(-1) for k in tpol.LEAVES])
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    r = ranks[0]
    np.testing.assert_allclose(r["tp2_autograd_params"], jflat, **TOL_PARAMS)
    assert np.abs(r["tp2_autograd_params"] - tppo.flatten_params(setup["tp"]).numpy()).max() > 1e-3
    assert int(r["tp2_autograd_count"]) == jadam.count == 1 + 4
    np.testing.assert_allclose(r["tp2_autograd_mu"], jadam.mu.numpy(), **TOL_PARAMS)
    np.testing.assert_allclose(r["tp2_autograd_nu"], jadam.nu.numpy(), **TOL_NU)
    np.testing.assert_allclose(r["tp2_autograd_aux"], np.stack([np.asarray(x) for x in jaux]),
                               **TOL_AUX)


def test_tp_make_train_step_matches_one_process(setup, ranks):
    """(d) ``make_train_step`` on (2, 2): the params, Adam's mu and the
    metrics against one process within JAX's tp tolerance, the rollout's
    state by tolerance (the split policy's actions move by ulps); (f) the
    four ranks' params bit-identical, each tp group's env state too."""
    inp = {"p_" + k: v.numpy() for k, v in zip(tpol.LEAVES, setup["tp"].leaves())}
    cfg = tppo.PPOConfig(**CFG_KW, rollout_steps=TRAIN["T"])
    env_cfg, env_params, ppo_cfg, ts = train_setup(cfg, TRAIN, setup["adam"], inp)
    ts2, m = tppo.make_train_step(ppo_cfg, env_cfg)(env_params, ts)
    for k in ("train_params", "train_mu", "train_metrics"):
        _ranks_equal(ranks, k)
    for group in _tp_groups("tp2"):
        for k in ("train_BG", "train_cgm_prev", "train_iob", "train_x"):
            _ranks_equal(ranks, k, group)
    got = lambda k: np.concatenate([ranks[g[0]][k] for g in _tp_groups("tp2")], axis=0)
    np.testing.assert_allclose(got("train_BG"), ts2.prev_res.BG.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got("train_x"), ts2.env_state.patient.x.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got("train_iob"), ts2.iob.numpy(), rtol=1e-5, atol=1e-6)
    r = ranks[0]
    np.testing.assert_allclose(r["train_params"], tppo.flatten_params(ts2.params).numpy(),
                               **TOL_TP)
    np.testing.assert_allclose(r["train_mu"], ts2.opt_state.mu.numpy(), **TOL_TP)
    np.testing.assert_allclose(r["train_metrics"], [float(m[k]) for k in sorted(m)], rtol=1e-5,
                               atol=1e-6)


def test_tp_fused_train_step_matches_one_process(ranks):
    """(e) The fused trainer on (2, 2) with the 'step' learner (run as
    autograd under tp) against the one-process observation-plane path with
    the autograd learner: the first iteration's simulator state bit for
    bit (each dp shard's K1b plain version with the whole MLP), the params
    after each of two iterations within JAX's tp tolerance; (f) the ranks'
    params bit-identical after each, each tp group's state too."""
    cfg, packed, ts = fused_setup(FUSED, False)
    step = tfused.make_fused_train_step(cfg, FUSED["B"], hidden=FUSED["H"], kernel_prep=False)
    for i in range(2):
        ts, m = step(packed, ts)
        _ranks_equal(ranks, f"fused_{i}_params")
        for group in _tp_groups("tp2"):
            for k in ("state_f", "state_i"):
                _ranks_equal(ranks, f"fused_{i}_{k}", group)
        np.testing.assert_allclose(ranks[0][f"fused_{i}_params"],
                                   tppo.flatten_params(ts.params).numpy(), err_msg=f"iteration {i}",
                                   **TOL_TP)
        assert np.isfinite(ranks[0][f"fused_{i}_metrics"]).all()
        if i == 0:
            state_f = np.concatenate([ranks[g[0]]["fused_0_state_f"] for g in _tp_groups("tp2")],
                                     axis=1)
            np.testing.assert_array_equal(state_f, ts.state_f.numpy())
    assert not np.array_equal(ranks[0]["fused_0_params"], ranks[0]["fused_1_params"])


def test_dryrun_multichip_four_ranks():
    """(g) The dry run on four gloo ranks on the CPU: ``(2, 2)`` and, on the
    same inputs, ``(4, 1)``: params bit-identical across the ranks of each,
    the two within rtol 2e-5 / atol 1e-6."""
    dryrun_multichip(4, device="cpu")


def test_dryrun_runs_on_the_card_unless_asked():
    """``dryrun_multichip`` defaults to the card: without CUDA it raises
    (before spawning a rank) unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(4)


def test_param_specs_are_jaxs():
    """Leaf by leaf, the dimension that 'tp' splits is where JAX's
    PartitionSpec names 'tp' (None where it is replicated); the metadata
    passes through."""
    kw = dict(act="relu", action_scale=1.1, scale_by_basal=True, decoder="residual_bb")
    jspecs, tspecs = jpol.param_specs(**kw), tpol.param_specs(**kw)
    for leaf in tpol.LEAVES:
        spec = getattr(jspecs, leaf)
        assert isinstance(spec, PartitionSpec)
        want = tuple(spec).index("tp") if "tp" in tuple(spec) else None
        assert getattr(tspecs, leaf) == want, leaf
    for f in kw:
        assert getattr(tspecs, f) == getattr(jspecs, f) == kw[f]


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2), (1, 4)])
def test_rank_coordinates_are_jaxs_device_order(dp, tp):
    """Rank r of a (dp, tp) mesh sits where JAX's ``make_mesh(dp, tp)``
    puts device r: ``(r // tp, r % tp)``, row-major."""
    jm = jmake_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(dp * tp):
        m = Mesh(dp=dp, tp=tp, rank=r, live=True)
        assert ids[m.dp_rank, m.tp_rank] == jax.devices()[r].id


def test_each_axis_reduces_over_its_group():
    """An axis that spans every rank reduces over the default group (None;
    on one rank too, as before tp), an axis of one rank among several is
    the identity (False), and on a 2-D mesh each axis takes its sub-group;
    a 2-D mesh built without ``make_mesh`` has none and raises."""
    groups = {"tp": "the tp group", "dp": "the dp group"}
    cases = [(Mesh(dp=1), {"dp": None, "tp": None, AXES: None}),
             (Mesh(dp=4, rank=2, live=True), {"dp": None, "tp": False, AXES: None}),
             (Mesh(dp=1, tp=4, rank=2, live=True), {"dp": False, "tp": None, AXES: None}),
             (Mesh(dp=2, tp=2, rank=3, live=True, groups=groups),
              {"dp": "the dp group", "tp": "the tp group", AXES: None})]
    for mesh, want in cases:
        for axis, group in want.items():
            assert sharding._axis_group(mesh, axis) == group, (mesh, axis)
    with pytest.raises(ValueError, match="axis must be"):
        sharding._axis_group(Mesh(dp=1), "pp")
    with pytest.raises(ValueError, match="no process sub-groups"):
        sharding._axis_group(Mesh(dp=2, tp=2, live=True), "tp")
