"""The port's streams keyed by global lane, and its mesh and tree helpers,
in one process.

* ``rollout(..., lane_offset=k)`` (the plain version) over a shard of the
  packed planes equals lanes ``[k, k+n)`` of the whole batch's rollout, bit
  for bit: PID with auto-reset from 23:00 (meal plans redrawn at midnight,
  resets drawn by ``draw_episode`` at the start and on each
  termination), BB with random meals, and the 'nn' controller in plane
  mode with sampled actions.  The JAX package offsets each device's seed
  by 7919 instead (``make_sharded_pallas_rollout``), which aliases streams
  and is not copied: without the offset the shard draws other numbers.
* ``shard_batch`` per rank of an 8-rank mesh against JAX's ``shard_batch``
  on the 8-device CPU mesh (each device's shard), ``local_batch_slice``
  against JAX's at 4 processes, ``local_shard`` and ``gather_to_host``;
  ``save_local_results`` writes this rank's patients.
* The refusals: ``tp > 1`` (ROADMAP queue 1 item 11b), a dp that is not
  the rank count, batches that do not divide, the learner-row mode and
  ``kernel_prep`` under a mesh (the JAX package's ValueErrors).
"""
import os
import types
from datetime import datetime, timedelta

import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.envs.build import cohort_names as jcohort_names
from simglucose_tpu.envs.build import make_env as jmake_env
from simglucose_tpu.parallel import multihost as jmultihost
from simglucose_tpu.parallel.sharding import make_mesh as jmake_mesh
from simglucose_tpu.parallel.sharding import shard_batch as jshard_batch
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.parallel import multihost, sharding
from simglucose_tpu_torch.parallel.sharding import Mesh
from simglucose_tpu_torch.rl import fused as tfused
from simglucose_tpu_torch.rl import ppo as tppo
from simglucose_tpu_torch.sim import engine

from test_torch_kernel_host import _nn_weights

torch.set_num_threads(1)

B = 384  # three lane rows; the shard is the last two


@pytest.fixture(scope="module")
def packed():
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    return tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))


LANE_CASES = {
    "pid_autoreset": tr.RolloutConfig(n_steps=40, controller="pid", fixed_start_min=1380,
                                      bg_done_high=180.0),
    "bb_random_meals": tr.RolloutConfig(n_steps=40, controller="bb", fixed_start_min=1380,
                                        bg_done_high=150.0),
    "nn_planes_sampled": tr.config_for_sensor("Dexcom", controller="nn", nn_hidden=16,
                                              n_steps=40, fixed_start_min=1380,
                                              bg_done_high=180.0),
}


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_lane_offset_rollout_is_the_whole_batch_lanes(packed, name):
    """A shard at ``lane_offset=128`` draws what lanes 128..383 of the
    whole batch draw: every output bit for bit, through the first draws,
    the midnight meal redraw and the auto-resets."""
    cfg = LANE_CASES[name]
    kw = dict(weights=_nn_weights(-1.5)) if cfg.controller == "nn" else {}
    whole = tr.rollout(cfg, packed, (7, 3), **kw)
    shard = tr.rollout(cfg, packed[:, 1:].contiguous(), (7, 3), lane_offset=128, **kw)
    for k, v in shard.items():
        if k.startswith("state"):
            ref = whole[k][:, 1:]
        elif v.ndim == 1:
            ref = whole[k][128:]
        else:
            ref = whole[k][..., 128:]
        assert torch.equal(v, ref), k
    assert shard["done"].any(), "the threshold must cause resets"
    aliased = tr.rollout(cfg, packed[:, 1:].contiguous(), (7, 3), **kw)
    assert not torch.equal(aliased["CGM"], shard["CGM"]), "the offset must move the streams"


def test_lane_offset_range_is_checked(packed):
    with pytest.raises(ValueError, match="lane_offset"):
        tr.rollout(LANE_CASES["pid_autoreset"], packed, 0, lane_offset=-128)


def _tree():
    _, params = jmake_env(jcohort_names(16), batch=True, dtype=np.float32)
    return params.patient


def test_shard_batch_matches_jax_per_device():
    """Rank r of an 8-rank mesh holds device r's shard of JAX's
    ``shard_batch`` on the 8-device mesh, leaf for leaf; the ranks' shards
    gathered in rank order are the tree (JAX's ``gather_to_host`` and
    ``local_shard``)."""
    jtree = _tree()
    ttree = from_jax(jtree, device="cpu")
    jsharded = jshard_batch(jtree, jmake_mesh(dp=8, tp=1))
    shards = [sharding.shard_batch(ttree, Mesh(dp=8, rank=r)) for r in range(8)]
    for f in ttree._fields:
        jleaf = getattr(jsharded, f)
        by_device = {s.device.id: np.asarray(s.data) for s in jleaf.addressable_shards}
        for r in range(8):
            np.testing.assert_array_equal(getattr(shards[r], f).numpy(), by_device[r], err_msg=f)
        local = [getattr(multihost.local_shard(s), f) for s in shards]
        np.testing.assert_array_equal(np.concatenate(local),
                                      getattr(jmultihost.local_shard(jsharded), f), err_msg=f)
    # one process: gather_to_host is each leaf on the host
    np.testing.assert_array_equal(sharding.gather_to_host(ttree).BW, np.asarray(jtree.BW))


def test_shard_batch_lane_axis_and_leaves_it_keeps():
    """``axis=1`` slices ``[T, B]`` planes by lane; 0-d tensors, ints and
    generators are replicated as they are."""
    planes = torch.arange(24.0).reshape(3, 8)
    g = torch.Generator()
    out = sharding.shard_batch({"p": planes, "s": torch.tensor(2.0), "n": 5, "g": g},
                               Mesh(dp=4, rank=2), axis=1)
    assert torch.equal(out["p"], planes[:, 4:6]) and out["p"].is_contiguous()
    assert out["s"].item() == 2.0 and out["n"] == 5 and out["g"] is g


@pytest.mark.parametrize("n,i", [(4, 0), (4, 3), (2, 1)])
def test_local_batch_slice_matches_jax(monkeypatch, n, i):
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(multihost, "process_index", lambda: i)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_index", lambda: i)
    assert multihost.local_batch_slice(16) == jmultihost.local_batch_slice(16)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_slice(15 if n == 4 else 7)


def test_save_local_results_writes_this_ranks_patients(monkeypatch, tmp_path):
    """Rank 1 of 2 writes the second half of the cohort, each patient's
    frame the one ``simulate`` writes for it."""
    names = tables.patient_names()[:4]
    res = engine.simulate_cohort(sim_time=timedelta(hours=1), patient_names=names, cgm_seed=3,
                                 device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    mesh = Mesh(dp=2, rank=1)
    local = (sharding.shard_batch(res.reset, mesh), sharding.shard_batch(res.traj, mesh, axis=1))
    df = multihost.save_local_results(local, names, datetime(2018, 1, 1), res.sample_time,
                                      str(tmp_path / "rank1"))
    assert sorted(os.listdir(tmp_path / "rank1")) == sorted(f"{n}.csv" for n in names[2:])
    whole = engine.simulate(sim_time=timedelta(hours=1), patient_names=names, cgm_seed=3,
                            device="cpu")
    for n in names[2:]:
        np.testing.assert_array_equal(df.loc[n].to_numpy(), whole.loc[n].to_numpy())


def test_mesh_refusals():
    """tp > 1 is item 11b; dp must be the rank count (one process here);
    a batch that does not divide raises, as JAX's does."""
    assert sharding.make_mesh() == Mesh(dp=1) == sharding.resolve_mesh(None)
    with pytest.raises(NotImplementedError, match="item 11b"):
        sharding.make_mesh(tp=2)
    with pytest.raises(ValueError, match="dp\\*tp=3"):
        sharding.make_mesh(dp=3)
    with pytest.raises(TypeError, match="Mesh"):
        sharding.check_mesh(object())
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_batch(torch.zeros(6), Mesh(dp=4))
    cfg = tr.RolloutConfig(n_steps=4)
    with pytest.raises(ValueError, match="2 ranks x 128 lanes"):
        tr.make_sharded_rollout(cfg, 384, Mesh(dp=2))
    with pytest.raises(ValueError, match="nn_emit_learner_rows"):
        tr.make_sharded_rollout(tr.RolloutConfig(controller="nn", nn_emit_learner_rows=True),
                                256, Mesh(dp=2))
    with pytest.raises(ValueError, match="kernel_prep=True needs"):
        tfused.make_fused_train_step(tppo.PPOConfig(pallas_learner="step"), 256, hidden=16,
                                     mesh=Mesh(dp=1), kernel_prep=True)
    with pytest.raises(NotImplementedError, match="item 11b"):
        tfused.make_fused_train_step(tppo.PPOConfig(), 256, hidden=16, mesh=Mesh(dp=1, tp=2))


def test_one_rank_mesh_is_the_unsharded_run(packed):
    """``make_sharded_rollout`` on a one-rank mesh is ``rollout`` itself,
    bit for bit."""
    cfg = LANE_CASES["pid_autoreset"]
    one = tr.make_sharded_rollout(cfg, B, Mesh(dp=1))(packed, (7, 3))
    ref = tr.rollout(cfg, packed, (7, 3))
    for k, v in ref.items():
        assert torch.equal(one[k], v), k


@pytest.mark.parametrize("config,kind,gather,want", [
    ("cpu:gloo,cuda:gloo", "cpu", True, "cpu"),
    ("cpu:gloo,cuda:gloo", "cuda", False, "cuda:0"),  # gloo reduces card tensors
    ("cpu:gloo,cuda:gloo", "cuda", True, "cpu"),  # but gathers host tensors only
    ("cpu:gloo,cuda:nccl", "cuda", True, "cuda:0"),
    ("cpu:gloo,cuda:nccl", "cpu", True, "cpu"),
    ("cuda:nccl", "cpu", False, "cuda:0"),  # NCCL alone: host tensors go to the card
])
def test_collectives_run_where_the_backend_serves_them(monkeypatch, config, kind, gather, want):
    """The device of a collective under each backend rule."""
    monkeypatch.setattr(sharding.dist, "get_backend_config", lambda: config)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    t = types.SimpleNamespace(device=torch.device("cuda:0" if kind == "cuda" else "cpu"))
    assert sharding._comm_device(t, gather) == torch.device(want)


def test_argument_digest_by_value_not_address():
    """Equal arguments give equal fingerprints (tensors by bytes, functions
    by name, dataclasses by field); another cohort order, seed, config
    field or tensor value gives another.  A mesh that is not live checks
    nothing."""
    cfg = tr.RolloutConfig(n_steps=4)
    base = (cfg, ["a", "b"], (1, 2), torch.arange(3.0), engine.simulate_cohort)
    same = (tr.RolloutConfig(n_steps=4), ["a", "b"], (1, 2), torch.arange(3.0),
            engine.simulate_cohort)
    fp = sharding._fingerprint
    assert fp(base) == fp(same)
    for other in ((cfg, ["b", "a"]) + base[2:], base[:2] + ((1, 3),) + base[3:],
                  (tr.RolloutConfig(n_steps=5),) + base[1:],
                  base[:3] + (torch.tensor([0.0, 1.0, 2.5]),) + base[4:]):
        assert fp(other) != fp(base)
    sharding.check_same(Mesh(dp=2, rank=1), "x", base)  # not live: no collective


def test_process_group_without_a_cluster_is_a_no_op(monkeypatch):
    """``multihost.process_group()`` joins no group where ``initialize()``
    finds no cluster environment, and leaves none; the two-rank files
    (tests/test_torch_multidevice_*.py) run it on live gloo groups."""
    import torch.distributed as dist

    from simglucose_tpu_torch.parallel.multihost import process_group

    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with process_group():
        assert not dist.is_initialized()
    assert not dist.is_initialized()
