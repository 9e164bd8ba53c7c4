"""The port's multi-device cohort simulation and evaluation on two gloo ranks
on the CPU, against the one-process port and the JAX package.

One spawn of two ranks (a ``file://`` store under the test's temporary
directory, one torch thread a rank) runs every case and writes an npz per
rank; the module-scoped fixture reads them, so process start-up is paid
once.  The ranks shard the padded cohort by 128-lane rows and key every
Philox draw by global lane, so the sharded results are the one-process
results bit for bit:

* ``simulate_cohort`` (K1a's plain version), 30 patients x 24 h BB with
  random meals (rank 1 holds padding lanes only), and 200 patients, PID
  with random initial BG, over a 6 h horizon cut into three calls
  (``MAX_STEPS_PER_CALL`` 50; patients 128-199 on rank 1): every plane,
  reset row and reward bit for bit;
* ``evaluate_policy_kernel`` (K1b's plain version in plane mode) over 200
  patients x 3 h with the mesh (JAX's ``shard=True``) and without it on
  the ranks, and in one process: bit for bit; ``evaluate_controller('BB')`` likewise;
* ``make_sharded_rollout`` of a deterministic PID config against the JAX
  ``make_sharded_pallas_rollout`` on a 2-device mesh in interpret mode, at
  tests/test_torch_rollout_pid.py's tolerances (BG/CGM rtol 2e-6, insulin
  rtol 1e-6, CHO and done exact, reward atol 1e-4).  JAX's per-device seed offset (+7919 per device)
  draws nothing in a deterministic config; the lane-offset streams that
  replace it are pinned by tests/test_torch_sharding.py;
* nothing shards without a mesh: rank 0 simulates alone while rank 1 goes
  on (no collective, no hang), and gets the one-process result;
* ranks that pass other arguments to a sharding entry point (a reversed
  cohort of the same size, another seed) all raise ValueError before the
  rollout, instead of mixing each other's patients.
"""
import json
import os
import subprocess
import sys
import textwrap
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.models.uva_padova import basal_rate as jbasal_rate
from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu.parallel.sharding import make_mesh as jmake_mesh
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import evaluate as tev
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.sim import engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
SPAWN_TIMEOUT_S = 300
H = 16
DET_B, DET_T = 256, 3

SPEC = dict(
    bb=dict(sim_time_h=24, scenario_seed=1, cgm_seed=2),
    chunked=dict(sim_time_h=6, controller=["PID", {"P": -2e-4}], cgm_seed=5, random_init_bg=True,
                 patient_names=tables.cohort_names(200)),
    chunk_steps=50,
    eval_names=tables.cohort_names(200),
    eval_hours=3.0,
    eval_seed=5,
)


def spawn_ranks(worker: str, workdir, n: int = N_RANKS) -> list:
    """Run ``worker`` (Python source) as ``n`` ranks, each with argv (rank,
    n, store path, workdir), from the repository root; every rank must exit
    0.  Returns each rank's ``rank{r}.npz`` as a dict."""
    workdir = str(workdir)
    store = os.path.join(workdir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(n), store, workdir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    out = []
    for r in range(n):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            out.append(dict(f))
    return out


WORKER = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    from datetime import timedelta
    import numpy as np, torch
    rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from simglucose_tpu_torch.parallel.multihost import initialize
    initialize(f"file://{store}", world_size=n, rank=rank, backend="gloo")
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.parallel.sharding import make_mesh
    from simglucose_tpu_torch.rl import evaluate as tev, policy as tpol
    from simglucose_tpu_torch.sim import engine

    spec = json.load(open(os.path.join(workdir, "spec.json")))
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    mesh = make_mesh()
    res = {}

    def put(prefix, cohort):
        for f, v in zip(cohort.traj._fields, cohort.traj):
            res[f"{prefix}_{f}"] = v
        for f, v in zip(cohort.reset._fields, cohort.reset):
            res[f"{prefix}_reset_{f}"] = v
        res[f"{prefix}_reward"] = cohort.reward

    def cohort_kw(c):
        kw = dict(c, sim_time=timedelta(hours=c["sim_time_h"]), device="cpu")
        del kw["sim_time_h"]
        if "controller" in kw:
            kw["controller"] = tuple(kw["controller"])
        return kw

    put("bb", engine.simulate_cohort(**cohort_kw(spec["bb"]), mesh=mesh))
    engine.MAX_STEPS_PER_CALL = spec["chunk_steps"]
    put("chunked", engine.simulate_cohort(**cohort_kw(spec["chunked"]), mesh=mesh))
    engine.MAX_STEPS_PER_CALL = 4096

    params = tpol.policy_from_numpy([inputs[k] for k in tpol.LEAVES], act="relu", device="cpu",
                                    action_scale=10.0, scale_by_basal=True)
    names = spec["eval_names"]
    for shard in (True, False):
        ev = tev.evaluate_policy_kernel(params, names, hours=spec["eval_hours"],
                                        seed=spec["eval_seed"], device="cpu",
                                        mesh=mesh if shard else None)
        for k in ("BG", "CGM", "insulin_mean", "risk_index"):
            res[f"policy_{shard}_{k}"] = ev[k]
    ev = tev.evaluate_controller("BB", names, hours=spec["eval_hours"], seed=spec["eval_seed"],
                                 device="cpu", mesh=mesh)
    for k in ("BG", "CGM", "insulin_mean"):
        res[f"bbeval_{k}"] = ev[k]

    det = tr.RolloutConfig(n_steps=int(inputs["det_T"]), deterministic=True, controller="pid")
    run = tr.make_sharded_rollout(det, int(inputs["det_B"]), mesh)
    packed = torch.from_numpy(inputs["det_packed"])
    for k, v in run(packed, 0).items():
        res[f"det_{k}"] = v.numpy()

    # rank 0 alone without a mesh while rank 1 goes on to the next case
    if rank == 0:
        put("alone", engine.simulate_cohort(**cohort_kw(spec["bb"])))
    # the ranks pass other arguments: each must raise before the rollout
    calls = dict(
        simulate_cohort=lambda: engine.simulate_cohort(
            sim_time=timedelta(hours=1), patient_names=tables.cohort_names(30)[::1 - 2 * rank],
            device="cpu", mesh=mesh),
        evaluate_controller=lambda: tev.evaluate_controller(
            "BB", names[:8], hours=0.5, seed=rank, device="cpu", mesh=mesh),
    )
    for what, call in calls.items():
        try:
            call()
            res[f"mismatch_{what}"] = "no error"
        except ValueError as e:
            res[f"mismatch_{what}"] = str(e)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    """
)


def _policy_arrays():
    rng = np.random.default_rng(7)
    shapes = dict(w1=(7, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,), log_std=(1,),
                  w_v=(H, 1), b_v=(1,))
    arrs = {k: rng.normal(0, np.sqrt(2.0 / s[0]), s).astype(np.float32) for k, s in shapes.items()}
    arrs["b_mu"][:] = -1.0
    arrs["log_std"][:] = -0.5
    return arrs


def _det_packed():
    """The JAX packed planes of the deterministic PID case (the port's
    layout too)."""
    _, params = make_env(cohort_names(DET_B), batch=True, dtype=np.float32)
    return jpr.pack_params(params.patient, jbasal_rate(params.patient))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice_sim")
    with open(d / "spec.json", "w") as f:
        json.dump(SPEC, f)
    np.savez(d / "inputs.npz", det_packed=np.asarray(_det_packed()), det_B=DET_B, det_T=DET_T,
             **_policy_arrays())
    return spawn_ranks(WORKER, d)


def _cohort_kw(c):
    kw = dict(c, sim_time=timedelta(hours=c["sim_time_h"]), device="cpu")
    del kw["sim_time_h"]
    if "controller" in kw:
        kw["controller"] = tuple(kw["controller"])
    return kw


def _assert_cohort_equal(r, prefix, res):
    for f, v in zip(res.traj._fields, res.traj):
        np.testing.assert_array_equal(r[f"{prefix}_{f}"], v, err_msg=f)
    for f, v in zip(res.reset._fields, res.reset):
        np.testing.assert_array_equal(r[f"{prefix}_reset_{f}"], v, err_msg=f"reset {f}")
    np.testing.assert_array_equal(r[f"{prefix}_reward"], res.reward)


def test_sharded_simulate_cohort_equals_one_process(ranks):
    """30 patients x 24 h BB with random meals on two ranks: every rank
    returns the one-process result, bit for bit."""
    one = engine.simulate_cohort(**_cohort_kw(SPEC["bb"]))
    assert one.traj.BG.shape == (480, 30)
    for r in ranks:
        _assert_cohort_equal(r, "bb", one)


def test_sharded_chunked_horizon_equals_one_process(ranks, monkeypatch):
    """200 patients, 6 h of PID with random initial BG cut into calls of
    50, 50 and 20 steps threading the sharded state: the one-process result
    (the one-process run also chunked, and uncut), bit for bit."""
    whole = engine.simulate_cohort(**_cohort_kw(SPEC["chunked"]))
    monkeypatch.setattr(engine, "MAX_STEPS_PER_CALL", SPEC["chunk_steps"])
    cut = engine.simulate_cohort(**_cohort_kw(SPEC["chunked"]))
    for r in ranks:
        _assert_cohort_equal(r, "chunked", cut)
        _assert_cohort_equal(r, "chunked", whole)


def test_sharded_policy_evaluation_equals_unsharded(ranks):
    """``evaluate_policy_kernel`` with the mesh equals it without one on
    the ranks and the one-process evaluation, bit for bit; so does
    ``evaluate_controller('BB')`` on K1a's plain version."""
    arrs = _policy_arrays()
    params = tpol.policy_from_numpy([arrs[k] for k in tpol.LEAVES], act="relu", device="cpu",
                                    action_scale=10.0, scale_by_basal=True)
    names = SPEC["eval_names"]
    one = tev.evaluate_policy_kernel(params, names, hours=SPEC["eval_hours"],
                                     seed=SPEC["eval_seed"], device="cpu")
    bb = tev.evaluate_controller("BB", names, hours=SPEC["eval_hours"], seed=SPEC["eval_seed"],
                                 device="cpu")
    assert one["BG"].shape == (200, 60) and one["insulin_mean"].max() > 0
    for r in ranks:
        for k in ("BG", "CGM", "insulin_mean", "risk_index"):
            np.testing.assert_array_equal(r[f"policy_True_{k}"], one[k], err_msg=k)
            np.testing.assert_array_equal(r[f"policy_False_{k}"], one[k], err_msg=k)
        for k in ("BG", "CGM", "insulin_mean"):
            np.testing.assert_array_equal(r[f"bbeval_{k}"], bb[k], err_msg=k)


def test_sharded_deterministic_pid_matches_jax_sharded_kernel(ranks):
    """Each rank's half of a 256-lane deterministic PID rollout against
    JAX's ``make_sharded_pallas_rollout`` on a 2-device mesh in interpret
    mode: the trajectories and the reset row of the gathered halves."""
    jcfg = jpr.PallasRolloutConfig(n_steps=DET_T, block_rows=1, t_chunk=DET_T, deterministic=True,
                                   controller="pid")
    mesh = jmake_mesh(dp=N_RANKS, tp=1, devices=jax.devices()[:N_RANKS])
    jt = jpr.make_sharded_pallas_rollout(jcfg, DET_B, mesh, interpret=True)(_det_packed(), 0)
    for r in ranks:
        assert r["det_BG"].shape == (DET_T, DET_B // N_RANKS)
    got = {k: np.concatenate([r[f"det_{k}"] for r in ranks], axis=-1)
           for k in ("BG", "CGM", "insulin", "reward", "CHO", "done", "BG0", "CGM0")}
    for k, kw in (("BG", dict(rtol=2e-6)), ("CGM", dict(rtol=2e-6)), ("insulin", dict(rtol=1e-6)),
                  ("reward", dict(atol=1e-4)), ("BG0", dict(rtol=1e-7)),
                  ("CGM0", dict(rtol=1e-7))):
        np.testing.assert_allclose(got[k], np.asarray(jt[k]), err_msg=k, **kw)
    for k in ("CHO", "done"):
        np.testing.assert_array_equal(got[k], np.asarray(jt[k]), err_msg=k)


def test_without_a_mesh_nothing_is_shared(ranks):
    """Rank 0 simulating alone (no mesh) inside the two-rank group makes no
    collective call and returns the one-process result."""
    one = engine.simulate_cohort(**_cohort_kw(SPEC["bb"]))
    _assert_cohort_equal(ranks[0], "alone", one)
    assert "alone_BG" not in ranks[1]


@pytest.mark.parametrize("what", ["simulate_cohort", "evaluate_controller"])
def test_ranks_with_other_arguments_raise(ranks, what):
    """A reversed cohort of the same size on rank 1 (simulate_cohort) and
    another seed (evaluate_controller): every rank raises ValueError,
    naming rank 1."""
    for r in ranks:
        msg = str(r[f"mismatch_{what}"])
        assert msg.startswith(f"{what}: rank(s) [1] passed other arguments"), msg
