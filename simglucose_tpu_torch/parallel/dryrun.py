"""The multi-rank dry run of the mesh paths.

Counterpart of ``__graft_entry__.py::dryrun_multichip``, stage for stage and
at its shapes, over ``n`` ranks:

(a) one ``make_train_step(mesh=)`` iteration on a ``(n/2, 2)`` mesh where
    ``n`` is even (else ``(n, 1)``), 4 patients a ``dp`` coordinate, T=4,
    H=64: the reward finite, the params moved and bit-identical on every
    rank;
(b) where ``n`` is even, the same inputs through ``(n, 1)`` over the same
    ranks: the updated params within rtol 2e-5 / atol 1e-6 of (a)'s (the
    JAX tolerance: the ``tp`` split is a layout choice, not a numerics
    choice);
(c) the sharded rollout kernel (``ops/rollout.py::make_sharded_rollout``)
    over ``(n, 1)``: ``Bk = n x 128`` lanes, PID, 2 steps, deterministic;
    BG ``[2, Bk]`` finite once gathered, and each rank's rows equal to the
    one-process rollout of all ``Bk`` lanes bit for bit;
(d) one fused PPO iteration over ``(n, 1)`` (``rl/fused.py``, the
    observation-plane path: K1b per rank, then the 'step' learner, K4 per
    rank): ``Bk`` lanes, relu H=16, mu bias -2.2, 2 steps, 1 epoch x 2
    minibatches; the reward finite, the params bit-identical on every rank;
(e) the persistent fused trainer at its stated scale: 32768 global lanes,
    H=64, 2 steps, 1 epoch x 2 minibatches (the autograd learner), two
    iterations: the simulator state of a rank under 100 MB, both rewards
    finite, the params bit-identical on every rank, and the second
    iteration continuing the first one's episodes (a lane's step counter
    advanced by the iteration's minutes).

It ends with the JAX function's OK line, field for field, naming the mesh
and the backend.  The one-process results that (c)-(e) are built from are
held against the JAX package by ``tests/test_torch_rollout_pid.py`` (K1a's
PID rollout) and ``tests/test_torch_plane.py`` (the plane path and its
learners); ``tests/test_torch_multidevice_sim.py`` and
``tests/test_torch_multidevice_learner.py`` hold the sharded paths against
one process.

Run it inside a live group, each rank on its card::

    torchrun --nproc-per-node=N -m simglucose_tpu_torch.parallel.dryrun N

or without one (``python -m simglucose_tpu_torch.parallel.dryrun N``): it
then spawns ``N`` ranks on ``device``, over the default backend where each
rank has a card of its own and over gloo where ranks share a card or run
on the CPU (:func:`~simglucose_tpu_torch.parallel.multihost.spawn_backend`).
``device="cpu"`` (``--device cpu``) runs either form on the CPU.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from simglucose_tpu_torch.core.device import check_device

TIMEOUT_S = 600
TP_RTOL, TP_ATOL = 2e-5, 1e-6
B_PERSISTENT = 32768  # stage (e)'s global lanes, the JAX function's "32K"
STATE_MB_LIMIT = 100.0  # stage (e): the simulator state a rank holds


def same_on_ranks(t: torch.Tensor, mesh, what: str) -> None:
    """Raise RuntimeError on every rank unless every rank of ``mesh``
    holds the same bits of ``t``."""
    from simglucose_tpu_torch.parallel.sharding import all_gather

    every = all_gather(t.detach().reshape(1, -1), mesh)
    differ = [r for r in range(len(every)) if not torch.equal(every[r], every[0])]
    if differ:
        raise RuntimeError(f"(dp={mesh.dp}, tp={mesh.tp}): {what} of rank(s) {differ} differ "
                           "from rank 0's")


def on_every_rank(mesh, fn):
    """``fn()`` on this rank, its RuntimeError raised on every rank of
    ``mesh`` (naming the ranks that failed): a check that fails on one rank
    alone would leave the others waiting in their next collective."""
    from simglucose_tpu_torch.parallel.sharding import all_gather

    try:
        out, err = fn(), None
    except RuntimeError as e:
        out, err = None, str(e)
    failed = all_gather(torch.tensor([[err is not None]], dtype=torch.int64), mesh)[:, 0]
    bad = failed.nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(f"rank(s) {bad} failed" + (f": {err}" if err else " (see their logs)"))
    return out


def rows_equal(got: torch.Tensor, whole: torch.Tensor, lanes: slice, what: str) -> None:
    """Raise RuntimeError unless a rank's ``[T, B/n]`` plane ``got`` is the
    one-process ``[T, B]`` plane ``whole`` at the rank's ``lanes``, bit
    for bit."""
    want = whole[:, lanes]
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"{what}: {bad} of the rank's {got.numel()} values differ from the "
                           "one-process rollout of the whole batch")


def check_state_bytes(nbytes: int) -> float:
    """The simulator state's MB on a rank, which must be under
    :data:`STATE_MB_LIMIT` (JAX's 100 MB)."""
    mb = nbytes / 1e6
    if not mb < STATE_MB_LIMIT:
        raise RuntimeError(f"the simulator state takes {mb:.1f} MB a rank "
                           f"(limit {STATE_MB_LIMIT} MB)")
    return mb


def check_continued(t_before: torch.Tensor, t_after: torch.Tensor, minutes: int) -> int:
    """The lanes whose episode went on through an iteration: their step
    counter (``state_i[0]``, minutes into the episode) advanced by the
    iteration's ``minutes``.  Raise RuntimeError where no lane did, or
    where one lane's counter went back without being reset (a counter
    past the iteration's minutes that did not advance by them)."""
    advanced = t_after == t_before + minutes
    fresh = t_after <= minutes  # a lane reset during the iteration
    if not bool(advanced.any()) or not bool((advanced | fresh).all()):
        raise RuntimeError(
            f"the second iteration did not continue the episodes: {int(advanced.sum())} of "
            f"{advanced.numel()} lanes advanced by {minutes} min, "
            f"{int((~(advanced | fresh)).sum())} neither advanced nor reset")
    return int(advanced.sum())


def _train_once(mesh, B: int, device):
    """Stages (a)/(b): one ``make_train_step`` iteration over ``B``
    patients split by ``mesh``.  Returns the flat updated params and the
    reward mean."""
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.parallel.sharding import replicate, shard_batch
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import (
        PPOConfig,
        TrainState,
        flatten_params,
        make_optimizer,
        make_train_step,
    )

    cfg, env_params = make_env(cohort_names(B), batch=True, random_init_bg=True, device=device)
    env_state, reset_res = batch_reset(cfg, env_params, env_keys((0, 0), B, device=device))
    ppo_cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    policy = init_policy(torch.Generator().manual_seed(1), hidden=64, device=device)
    ts = TrainState(params=replicate(policy, mesh),
                    opt_state=replicate(make_optimizer(ppo_cfg).init(policy), mesh),
                    env_state=shard_batch(env_state, mesh), prev_res=shard_batch(reset_res, mesh),
                    key=shard_batch(env_keys((0, 1), B, device=device), mesh),
                    generator=replicate(torch.Generator().manual_seed(2), mesh))
    ts2, metrics = make_train_step(ppo_cfg, cfg, mesh=mesh)(shard_batch(env_params, mesh), ts)
    where = f"rank {mesh.rank} of (dp={mesh.dp}, tp={mesh.tp})"
    if not torch.isfinite(metrics["reward_mean"]):
        raise RuntimeError(f"{where}: reward_mean {metrics['reward_mean']} not finite")
    flat = flatten_params(ts2.params)
    if torch.equal(flat, flatten_params(ts.params)):
        raise RuntimeError(f"{where}: the update left the params as they were")
    same_on_ranks(flat, mesh, "the params after the update")
    return flat, float(metrics["reward_mean"])


def _packed(B: int, device) -> torch.Tensor:
    """The packed parameter planes of the first ``B`` cohort patients."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params

    patient = tables.load_patient_params(tables.cohort_names(B), device=device)
    return pack_params(patient, basal_rate(patient))


def _sharded_rollout(kmesh, n: int, device) -> int:
    """Stage (c): the sharded rollout over ``(n, 1)``; returns ``Bk``."""
    from simglucose_tpu_torch.ops.rollout import LANES, RolloutConfig, make_sharded_rollout, rollout
    from simglucose_tpu_torch.parallel.sharding import gather_lanes

    Bk = n * LANES
    packed = _packed(Bk, device)
    pcfg = RolloutConfig(n_steps=2, deterministic=True, controller="pid")
    traj = make_sharded_rollout(pcfg, Bk, kmesh)(packed, 0)
    bg = gather_lanes(traj["BG"], kmesh)
    if bg.shape != (2, Bk) or not bool(torch.isfinite(bg).all()):
        raise RuntimeError(f"sharded rollout: BG of shape {tuple(bg.shape)}, finite "
                           f"{bool(torch.isfinite(bg).all())}; want (2, {Bk}) and finite")
    whole = rollout(pcfg, packed, 0)
    lanes = slice(kmesh.dp_rank * LANES, (kmesh.dp_rank + 1) * LANES)
    on_every_rank(kmesh, lambda: [rows_equal(traj[k], whole[k], lanes, f"the sharded rollout's {k}")
                                  for k in ("BG", "CGM", "insulin", "reward")])
    return Bk


def _fused(kmesh, B: int, hidden: int, cfg, seeds, device, iters: int):
    """Stages (d)/(e): ``iters`` fused PPO iterations over ``B`` global
    lanes on ``kmesh``, the params bit-identical on every rank after each.
    Returns the states after each iteration and the reward means."""
    from simglucose_tpu_torch.parallel.sharding import replicate
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_step
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import flatten_params, make_optimizer

    policy = init_policy(torch.Generator().manual_seed(seeds[0]), hidden=hidden,
                         init_mu_bias=-2.2, act="relu", device=device)
    policy = replicate(policy, kmesh)
    ts = init_fused_state(policy, replicate(make_optimizer(cfg).init(policy), kmesh), B,
                          replicate(torch.Generator().manual_seed(seeds[1]), kmesh), mesh=kmesh)
    step = make_fused_train_step(cfg, B, hidden=hidden, mesh=kmesh)
    packed = _packed(B, device)
    states, rewards = [], []
    for i in range(iters):
        ts, m = step(packed, ts)
        if not torch.isfinite(m["reward_mean"]):
            raise RuntimeError(f"fused PPO at B={B}, H={hidden}, iteration {i}: reward_mean "
                               f"{m['reward_mean']} not finite")
        same_on_ranks(flatten_params(ts.params), kmesh,
                      f"the fused trainer's params (B={B}, H={hidden}) after iteration {i}")
        states.append(ts)
        rewards.append(float(m["reward_mean"]))
    return states, rewards


def _dryrun(n: int, device) -> dict:
    """Stages (a)-(e) on this rank of a live group of ``n`` ranks; returns
    the summary (the same on every rank)."""
    from simglucose_tpu_torch.ops.rollout import LANES
    from simglucose_tpu_torch.parallel.sharding import all_reduce_sum, make_mesh
    from simglucose_tpu_torch.rl.fused import fused_rollout_config
    from simglucose_tpu_torch.rl.ppo import PPOConfig

    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    B = dp * 4  # 4 patients a dp coordinate of the first mesh
    flat, reward = _train_once(make_mesh(dp=dp, tp=tp), B, device)
    if tp == 2:
        flat1, _ = _train_once(make_mesh(dp=n, tp=1), B, device)
        if not torch.allclose(flat, flat1, rtol=TP_RTOL, atol=TP_ATOL):
            err = float((flat - flat1).abs().max())
            raise RuntimeError(f"tp=2 against tp=1: the updated params differ by up to {err:.3g} "
                               f"(rtol {TP_RTOL:g}, atol {TP_ATOL:g})")

    kmesh = make_mesh(dp=n, tp=1)  # the kernels shard over every rank
    Bk = _sharded_rollout(kmesh, n, device)

    fcfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2, pallas_learner="step")
    _, (fused_reward,) = _fused(kmesh, Bk, 16, fcfg, (2, 3), device, iters=1)

    cfg32 = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    (ts1, ts2), rewards32 = _fused(kmesh, B_PERSISTENT, 64, cfg32, (4, 5), device, iters=2)
    rows = B_PERSISTENT // LANES // n
    if ts1.state_f.shape[1:] != (rows, LANES):
        raise RuntimeError(f"the persistent state has shape {tuple(ts1.state_f.shape)}; want "
                           f"[*, {rows}, {LANES}] a rank")
    state_mb = check_state_bytes(ts1.state_f.nbytes + ts1.state_i.nbytes)
    minutes = cfg32.rollout_steps * fused_rollout_config(cfg32, 64).sample_time
    carried = torch.tensor([on_every_rank(kmesh, lambda: check_continued(
        ts1.state_i[0], ts2.state_i[0], minutes))], device=ts2.state_i.device)
    carried = int(all_reduce_sum(carried, kmesh, "dp"))
    return dict(mesh=(dp, tp), backend=dist.get_backend_config(), B=B, reward_mean=reward,
                tp_parity=tp == 2, kernel_dp=n, Bk=Bk, fused_reward=fused_reward,
                B32=B_PERSISTENT, state_mb=state_mb, reward32=rewards32[0],
                carried_lanes=carried)


def ok_line(s: dict) -> str:
    """The JAX function's OK line, field for field, with the backend."""
    dp, tp = s["mesh"]
    parity = "tp=2 vs tp=1 learner parity OK" if s["tp_parity"] else \
        "tp=2 vs tp=1 learner parity not run (odd rank count)"
    return (f"dryrun_multichip OK: mesh=(dp={dp},tp={tp}), backend={s['backend']}, "
            f"B={s['B']}, reward_mean={s['reward_mean']:.4f}; {parity}; "
            f"sharded rollout kernel OK (dp={s['kernel_dp']}, B={s['Bk']}); "
            f"fused PPO step OK (reward={s['fused_reward']:.4f}); "
            f"{s['B32'] // 1024}K-lane persistent fused trainer OK (B={s['B32']}, hidden=64, "
            f"state {s['state_mb']:.2f} MB/rank, reward={s['reward32']:.4f}, "
            f"{s['carried_lanes']} lanes carried into the second iteration)")


def _rank_main(rank: int, n: int, init_file: str, device: str, backend: str, out: str) -> None:
    from simglucose_tpu_torch.parallel.multihost import process_group

    torch.set_num_threads(1)
    with process_group(f"file://{init_file}", world_size=n, rank=rank, backend=backend):
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
            torch.device(device)
        summary = _dryrun(n, dev)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(summary, f)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Stages (a)-(e) over ``n_devices`` ranks: the live group's ranks (the
    group must have ``n_devices`` ranks), or ``n_devices`` ranks spawned
    here on the backend :func:`~simglucose_tpu_torch.parallel.multihost.spawn_backend`
    picks, said in a line.  Every rank runs on ``device``: ``"cuda"`` (each
    rank's current card) raises where CUDA is absent; ``"cpu"`` asks for
    the CPU.  Prints the OK line (rank 0 of a live group) and returns the
    summary; raises if a stage or a rank fails."""
    from simglucose_tpu_torch.parallel.multihost import spawn_backend

    device = check_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"need {n_devices} ranks, the group has {dist.get_world_size()}")
        summary = _dryrun(n_devices, device)
        if dist.get_rank() == 0:
            print(ok_line(summary), flush=True)
        return summary
    backend = spawn_backend(n_devices, device)
    print(f"dryrun_multichip: {n_devices} ranks spawned on {device.type} over {backend} "
          f"({torch.cuda.device_count() if device.type == 'cuda' else 0} cards)", flush=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init_file, out = os.path.join(d, "store"), os.path.join(d, "summary.json")
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, init_file, device.type,
                                                      backend, out))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dry-run ranks exited with {codes}")
        with open(out) as f:
            summary = json.load(f)
    summary["mesh"] = tuple(summary["mesh"])
    print(ok_line(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    """``python -m simglucose_tpu_torch.parallel.dryrun N [--device cpu]``:
    under ``torchrun`` each rank joins the group and the dry run runs on
    it; otherwise it spawns ``N`` ranks."""
    from simglucose_tpu_torch.parallel.multihost import process_group

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    with process_group():
        return dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
