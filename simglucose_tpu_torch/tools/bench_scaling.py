"""What decides the port's data-parallel scaling: the collectives of the
sharded rollout and of the data-parallel learner, counted on live ranks.

Counterpart of ``tools/bench_scaling.py``.  The JAX tool compiles the
sharded programs over a virtual 8-device mesh and counts the collective
ops in their HLO.  The port has no HLO: here ``n`` ranks of a
``torch.distributed`` group (spawned by this tool, a ``file://`` store,
gloo by default) run one call of each path while every collective of
``torch.distributed`` is wrapped to record its name and the bytes it
moves:

1. ``rollout``: :func:`~simglucose_tpu_torch.ops.rollout.make_sharded_rollout`
   (PID, 2 steps, 128 lanes a rank), which should make no collective: each
   rank's throughput is then independent of the rank count;
2. ``learner``: :func:`~simglucose_tpu_torch.rl.ppo._update` under the mesh
   with the grad-step learner ('step', K4 per rank; relu 7-64-64, 1 epoch x
   2 minibatches), which should make one all-reduce of the minibatches'
   advantage statistics and one per minibatch of the gradient and loss
   sums;
3. ``fused_step``: one :func:`~simglucose_tpu_torch.rl.fused.make_fused_train_step`
   iteration under the mesh ('step', the observation-plane path): the
   learner's collectives plus one all-reduce of the metrics.

The JAX tool's modelled ICI efficiency is a TPU number and is not carried
over; no time is modelled here.

Usage::

    python -m simglucose_tpu_torch.tools.bench_scaling [--ranks 2] [--device cpu]

``--device cuda`` (the default) puts rank r on ``cuda:(r % cards)``; two
ranks sharing a card take gloo (NCCL refuses that).  Prints a line per
path and one JSON line: ``{"ranks", "backend", "device", "policy_params",
"rollout", "learner", "fused_step"}``, each path a list of ``{"op",
"bytes"}`` in call order (rank 0's; every rank must record the same).
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import sys
import tempfile

import torch
import torch.distributed as dist

TIMEOUT_S = 600
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
               "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather", "scatter")
LEARNER_CFG = dict(rollout_steps=8, epochs=1, minibatches=2, pallas_learner="step")
HIDDEN = 64


def _nbytes(args) -> int:
    """The bytes of the tensors among a collective's arguments (a list of
    tensors counts its first: the other entries are outputs)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], torch.Tensor):
            return a[0].numel() * a[0].element_size()
    return 0


def count_collectives(record: list):
    """Wrap ``torch.distributed``'s collectives so that each call appends
    ``{"op", "bytes"}`` to ``record``.  Returns a function that unwraps
    them."""
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, _name=name, **kw):
            record.append({"op": _name, "bytes": _nbytes(args)})
            return _fn(*args, **kw)

        setattr(dist, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)

    return restore


def _paths(device) -> dict:
    """Run each path once on this rank and return its collectives."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.parallel.sharding import make_mesh, replicate, shard_batch
    from simglucose_tpu_torch.rl import fused, policy, ppo

    mesh = make_mesh()
    B = mesh.dp * tr.LANES
    patient = tables.load_patient_params(tables.cohort_names(B), device=device)
    packed = tr.pack_params(patient, basal_rate(patient))
    cfg = ppo.PPOConfig(**LEARNER_CFG)
    params = replicate(policy.init_policy(torch.Generator().manual_seed(1), hidden=HIDDEN,
                                          act="relu", device=device), mesh)
    opt = ppo.make_optimizer(cfg)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(cfg.rollout_steps, B, policy.OBS_DIM + 6, generator=gen).to(device)
    traj = ppo.Transition(obs=x[..., :policy.OBS_DIM], raw_action=x[..., 7], logp=x[..., 8] - 1.0,
                          value=x[..., 9], reward=x[..., 10],
                          done=torch.zeros_like(x[..., 11]))
    traj = ppo.Transition(*(shard_batch(t, mesh, axis=1) for t in traj))
    advs, rets = shard_batch(x[..., 11], mesh, axis=1), shard_batch(x[..., 12], mesh, axis=1)
    runs = {
        "rollout": lambda: tr.make_sharded_rollout(
            tr.RolloutConfig(n_steps=2, controller="pid"), B, mesh)(packed, 0),
        "learner": lambda: ppo._update(cfg, opt, params, opt.init(params), traj, advs, rets,
                                       generator=torch.Generator().manual_seed(4), mesh=mesh),
        "fused_step": lambda: fused.make_fused_train_step(cfg, B, hidden=HIDDEN, mesh=mesh)(
            packed, fused.init_fused_state(params, opt.init(params), B,
                                           torch.Generator().manual_seed(5), mesh=mesh)),
    }
    out = {}
    for name, run in runs.items():
        record = []
        restore = count_collectives(record)
        try:
            run()
        finally:
            restore()
        out[name] = record
    out["policy_params"] = int(ppo.flatten_params(params).numel())
    return out


def _rank_main(rank: int, n: int, store: str, device: str, backend: str, outdir: str) -> None:
    from simglucose_tpu_torch.parallel.multihost import process_group

    torch.set_num_threads(1)
    with process_group(f"file://{store}", world_size=n, rank=rank, backend=backend):
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(_paths(torch.device(dev)), f)


def run_ranks(n: int = 2, device="cuda", backend: str = "gloo") -> dict:
    """Spawn ``n`` ranks, count each path's collectives on every rank, and
    return rank 0's record (every rank's must be equal)."""
    from simglucose_tpu_torch.core.device import check_device

    device = check_device(device).type
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, os.path.join(d, "store"), device, backend, d))
                 for r in range(n)]
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
            raise RuntimeError(f"bench_scaling ranks exited with {codes}")
        records = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                records.append(json.load(f))
    if any(rec != records[0] for rec in records[1:]):
        raise RuntimeError(f"the ranks recorded different collectives: {records}")
    return dict(ranks=n, backend=backend, device=device, **records[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    out = run_ranks(args.ranks, args.device, args.backend)
    n_grad = out["policy_params"]
    for name in ("rollout", "learner", "fused_step"):
        calls = out[name]
        shown = ", ".join(f"{c['op']} {c['bytes']} B" for c in calls) or "none"
        print(f"{name} (dp={args.ranks}): {len(calls)} collectives: {shown}", flush=True)
    print(f"policy: {n_grad} params = {n_grad * 4} B of float32 gradients", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
