"""A multi-rank dry run of the data-parallel trainer.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` for its ``dp``
part: one ``make_train_step(mesh=)`` iteration on tiny shapes over
``n_devices`` ranks, its reward finite and the ranks' parameters
bit-identical after the update.  The JAX function's tp=2 against tp=1
parity waits for ROADMAP queue 1 item 11b.

Run it inside a live group (``torchrun --nproc-per-node=N python -c
"from simglucose_tpu_torch.parallel.dryrun import dryrun_multichip;
dryrun_multichip(N)"``), or without one: it then spawns ``n_devices`` gloo
ranks on the CPU.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile

import torch
import torch.distributed as dist

TIMEOUT_S = 300


def _train_once(device) -> None:
    """One iteration at 4 patients a rank: finite reward, equal params."""
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.parallel.sharding import (
        gather_lanes,
        make_mesh,
        replicate,
        shard_batch,
    )
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import (
        PPOConfig,
        TrainState,
        flatten_params,
        make_optimizer,
        make_train_step,
    )

    mesh = make_mesh()
    B = mesh.dp * 4
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
    if not torch.isfinite(metrics["reward_mean"]):
        raise RuntimeError(f"rank {mesh.rank}: reward_mean {metrics['reward_mean']} not finite")
    flat = flatten_params(ts2.params)
    if torch.equal(flat, flatten_params(ts.params)):
        raise RuntimeError(f"rank {mesh.rank}: the update left the params as they were")
    every = gather_lanes(flat[None], mesh, axis=0)
    if not all(torch.equal(e, every[0]) for e in every):
        raise RuntimeError("the ranks' params differ after the update")


def _rank_main(rank: int, n: int, init_file: str) -> None:
    from simglucose_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world_size=n, rank=rank, backend="gloo")
    try:
        _train_once("cpu")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel training iteration over ``n_devices`` ranks: the
    live group's (each rank on its device; the group must have
    ``n_devices`` ranks), or ``n_devices`` gloo ranks spawned on the CPU.
    Raises if a rank fails."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"need {n_devices} ranks, the group has {dist.get_world_size()}")
        _train_once("cuda" if torch.cuda.is_available() else "cpu")
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init_file = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, init_file))
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
