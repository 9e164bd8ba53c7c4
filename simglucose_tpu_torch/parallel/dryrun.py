"""A multi-rank dry run of the mesh trainer.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: one
``make_train_step(mesh=)`` iteration on tiny shapes over ``n_devices``
ranks, on a ``(n/2, 2)`` mesh where ``n`` is even (else ``(n, 1)``), its
reward finite and every rank's parameters bit-identical after the update.
Where ``n`` is even, the same inputs through the ``(n, 1)`` mesh over the
same ranks must give the same updated params within rtol 2e-5 and atol 1e-6
(the JAX tolerance: the ``tp`` split is a layout choice, not a numerics
choice).

Run it inside a live group (``torchrun --nproc-per-node=N python -c
"from simglucose_tpu_torch.parallel.dryrun import dryrun_multichip;
dryrun_multichip(N)"``), each rank on its card, or without one: it then
spawns ``n_devices`` gloo ranks on ``device`` (on one card they share
it).  ``device="cpu"`` runs either on the CPU.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile

import torch
import torch.distributed as dist

from simglucose_tpu_torch.core.device import check_device

TIMEOUT_S = 300
TP_RTOL, TP_ATOL = 2e-5, 1e-6


def _train_once(mesh, B: int, device) -> torch.Tensor:
    """One iteration over ``B`` patients split by ``mesh``: finite reward,
    moved params, every rank's params bit-identical.  Returns the flat
    updated params."""
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.parallel.sharding import all_gather, replicate, shard_batch
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
    every = all_gather(flat[None], mesh)
    if not all(torch.equal(e, every[0]) for e in every):
        raise RuntimeError(f"(dp={mesh.dp}, tp={mesh.tp}): the ranks' params differ after the "
                           "update")
    return flat


def _dryrun(n: int, device) -> None:
    """The iteration on ``(n/2, 2)`` and, on the same inputs, on ``(n, 1)``
    (``(n, 1)`` alone for an odd ``n``)."""
    from simglucose_tpu_torch.parallel.sharding import make_mesh

    tp = 2 if n % 2 == 0 else 1
    B = n // tp * 4  # 4 patients a dp coordinate of the first mesh
    flat = _train_once(make_mesh(dp=n // tp, tp=tp), B, device)
    if tp == 2:
        flat1 = _train_once(make_mesh(dp=n, tp=1), B, device)
        if not torch.allclose(flat, flat1, rtol=TP_RTOL, atol=TP_ATOL):
            err = float((flat - flat1).abs().max())
            raise RuntimeError(f"tp=2 against tp=1: the updated params differ by up to {err:.3g} "
                               f"(rtol {TP_RTOL:g}, atol {TP_ATOL:g})")


def _rank_main(rank: int, n: int, init_file: str, device: str) -> None:
    from simglucose_tpu_torch.parallel.multihost import process_group

    torch.set_num_threads(1)
    with process_group(f"file://{init_file}", world_size=n, rank=rank, backend="gloo"):
        _dryrun(n, device)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One training iteration over ``n_devices`` ranks, and the tp=2
    against tp=1 parity where ``n_devices`` is even: the live group's
    ranks (the group must have ``n_devices`` ranks), or ``n_devices`` gloo
    ranks spawned here.  Every rank runs on ``device``: ``"cuda"`` (each
    rank's current card) raises where CUDA is absent; ``"cpu"`` asks for
    the CPU.  Raises if a rank fails."""
    device = check_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"need {n_devices} ranks, the group has {dist.get_world_size()}")
        _dryrun(n_devices, device)
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init_file = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, init_file, device.type))
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
