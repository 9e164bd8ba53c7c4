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
over; no time is modelled here.  ``--rates`` measures instead: one rank
alone, then ``n`` ranks, each row of :data:`RATES` over a mesh of the
ranks, every round timed by the bench's loop
(:func:`~simglucose_tpu_torch.tools.bench._round_seconds`: a barrier, the
card synchronized at both ends, the slowest rank's time), each rank on one
host thread:

* ``fused``: the fused mesh trainer ('step', the observation-plane path,
  relu H=64, 2 epochs x 4 minibatches of 2048-row blocks) at ``fused_B``
  lanes a rank (weak scaling), loops of ``fused_iters`` iterations
  (:func:`~simglucose_tpu_torch.tools.bench._fused_rounds`);
* ``train_dp`` / ``train_tp``: ``make_train_step`` (the f32 autograd
  learner, tanh H=``train_H``) at ``train_B`` patients in all on ``(n,
  1)`` and ``(n/2, 2)``, one iteration a round;
* ``sim_weak`` / ``sim_strong``: ``simulate_cohort`` (BB) at ``sim_B``
  patients a rank and in all;
* ``eval``: ``evaluate_policy_kernel`` of the residual-BB checkpoint at
  ``sim_B`` lanes.

Each row gives its rounds and their median; ``ratio`` is the ranks' median
rate over one rank's (times: one rank's median over the ranks'), so weak
scaling holds where it is 1 and strong scaling where it is ``n``.

Usage::

    python -m simglucose_tpu_torch.tools.bench_scaling [--ranks 2] [--device cpu] [--rates]

``--device cuda`` (the default) puts rank r on ``cuda:(r % cards)``; the
backend defaults to ``multihost.spawn_backend``'s: NCCL for card tensors
and gloo for host ones where each rank has a card of its own, gloo where
ranks share a card (NCCL refuses that) or run on the CPU.  Prints a line per
path and one JSON line: ``{"ranks", "backend", "device", "policy_params",
"rollout", "learner", "fused_step"}``, each path a list of ``{"op",
"bytes"}`` in call order (rank 0's; every rank must record the same);
with ``--rates`` a line per row and one JSON line ``{"ranks", "backend",
"device", "sizes", "one", "ranked", "ratio"}``.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 600
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
               "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather", "scatter")
LEARNER_CFG = dict(rollout_steps=8, epochs=1, minibatches=2, pallas_learner="step")
HIDDEN = 64
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# --rates: the fused trainer at phase 6's config (8192 lanes a card, T=64),
# make_train_step at phase 11's (8192 patients, T=64, tanh H=128),
# simulate_cohort and the evaluation at 4096 lanes x 24 h; ``rounds``
# timed calls a row after one, ``train_rounds`` for make_train_step (an
# iteration takes seconds)
RATES = dict(fused_B=8192, fused_T=64, fused_iters=30, train_B=8192, train_T=64, train_H=128,
             sim_B=4096, hours=24, rounds=9, train_rounds=3)


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


def _train_state(sizes: dict, device, mesh):
    """make_train_step's config, env and a fresh state at ``sizes``: the
    global cohort's env, this rank's patients of the state, the params,
    optimizer state and generator the same on every rank."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.envs.build import make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.parallel.sharding import shard_batch
    from simglucose_tpu_torch.rl import policy, ppo

    B = sizes["train_B"]
    env_cfg, env_params = make_env(tables.cohort_names(B), batch=True, random_init_bg=True,
                                   device=device)
    cfg = ppo.PPOConfig(rollout_steps=sizes["train_T"], epochs=2, minibatches=4,
                        pallas_learner=False)
    state, r0 = batch_reset(env_cfg, env_params, env_keys(21, B, device=device))
    p = policy.init_policy(torch.Generator().manual_seed(22), hidden=sizes["train_H"],
                           device=device)
    ts = ppo.TrainState(p, ppo.make_optimizer(cfg).init(p), shard_batch(state, mesh),
                        shard_batch(r0, mesh), shard_batch(env_keys((23, 24), B, device=device),
                                                           mesh),
                        torch.Generator().manual_seed(25))
    return cfg, env_cfg, shard_batch(env_params, mesh), ts


def _rates(device, sizes: dict) -> dict:
    """Each row of the module docstring on this rank, over a mesh of every
    rank: its rounds (iterations/s for ``fused``, else seconds), each the
    slowest rank's, and the lanes it ran."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.parallel.sharding import make_mesh
    from simglucose_tpu_torch.rl import evaluate, policy, ppo
    from simglucose_tpu_torch.sim.engine import simulate_cohort
    from simglucose_tpu_torch.tools.bench import _fused_rounds, _round_seconds

    mesh = make_mesh()
    n, rounds = mesh.dp, sizes["rounds"]
    cfg = ppo.PPOConfig(rollout_steps=sizes["fused_T"], epochs=2, minibatches=4,
                        pallas_learner="step", shuffle_block=2048)
    B = sizes["fused_B"] * n
    out = {"fused": dict(B=B, rounds=_fused_rounds(cfg, B, sizes["fused_iters"], HIDDEN, device,
                                                   mesh, rounds))}
    meshes = {"train_dp": mesh}
    if n > 1 and n % 2 == 0:
        meshes["train_tp"] = make_mesh(dp=n // 2, tp=2)
    for name, m in meshes.items():
        tcfg, env_cfg, env_params, carry = _train_state(sizes, device, m)
        train = ppo.make_train_step(tcfg, env_cfg, mesh=m)

        def run():
            nonlocal carry
            carry, metrics = train(env_params, carry)
            if not all(bool(torch.isfinite(v)) for v in metrics.values()):
                raise AssertionError(f"{name}: non-finite metrics {metrics}")

        out[name] = dict(B=sizes["train_B"], rounds=_round_seconds(run, sizes["train_rounds"],
                                                                   device, m))
    sims = {"sim_weak": sizes["sim_B"] * n}
    if n > 1:
        sims["sim_strong"] = sizes["sim_B"]
    for name, Bs in sims.items():
        kw = dict(sim_time=timedelta(hours=sizes["hours"]), patient_names=tables.cohort_names(Bs),
                  scenario_seed=6, cgm_seed=7, device=device, mesh=mesh)
        out[name] = dict(B=Bs, rounds=_round_seconds(lambda: simulate_cohort(**kw), rounds,
                                                     device, mesh))
    resid = policy.load_policy_npz(
        os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_residual_bb.npz"),
        device=device, act="relu", action_scale=1.1, decoder="residual_bb")
    names = tables.cohort_names(sizes["sim_B"])
    out["eval"] = dict(B=sizes["sim_B"], rounds=_round_seconds(
        lambda: evaluate.evaluate_policy_kernel(resid, names, hours=sizes["hours"], seed=5,
                                                device=device, mesh=mesh), rounds, device, mesh))
    for row in out.values():
        row["median"] = statistics.median(row["rounds"])
    return out


def _rank_main(rank: int, n: int, store: str, device: str, backend: str, outdir: str,
               rates) -> None:
    from simglucose_tpu_torch.parallel.multihost import process_group

    torch.set_num_threads(1)
    with process_group(f"file://{store}", world_size=n, rank=rank, backend=backend):
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
        record = _paths(torch.device(dev)) if rates is None else _rates(torch.device(dev), rates)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)


def run_ranks(n: int = 2, device="cuda", backend=None, rates=None) -> dict:
    """Spawn ``n`` ranks on ``backend`` (by default ``spawn_backend``'s
    choice), count each path's collectives on every rank (or, given
    ``rates``, a dict of :data:`RATES`' sizes, time its rows), and return
    rank 0's record (every rank's must be equal)."""
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.parallel.multihost import spawn_backend

    device = check_device(device).type
    backend = backend or spawn_backend(n, device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, os.path.join(d, "store"), device, backend, d, rates))
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


# the one-rank row that a row of n ranks is held to, where it has another name
_ONE_RANK_ROW = {"train_tp": "train_dp", "sim_strong": "sim_weak"}


def run_rates(n: int, device="cuda") -> dict:
    """:data:`RATES`' rows on one rank alone, then on ``n`` ranks of
    ``spawn_backend``'s choice; each row's ratio of medians."""
    one = run_ranks(1, device, rates=RATES)
    ranked = run_ranks(n, device, rates=RATES)
    ratio = {}
    for name, row in ranked.items():
        if name in ("ranks", "backend", "device"):
            continue
        base = one[_ONE_RANK_ROW.get(name, name)]
        ratio[name] = (row["median"] / base["median"] if name == "fused"
                       else base["median"] / row["median"])
    strip = lambda rec: {k: v for k, v in rec.items() if k not in ("ranks", "backend", "device")}
    return dict(ranks=n, backend=ranked["backend"], device=ranked["device"], sizes=RATES,
                one=strip(one), ranked=strip(ranked), ratio=ratio)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None)
    ap.add_argument("--rates", action="store_true",
                    help="time RATES' rows on one rank, then on --ranks ranks")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.rates:
        out = run_rates(args.ranks, args.device)
        for name, r in out["ratio"].items():
            base = out["one"][_ONE_RANK_ROW.get(name, name)]
            row = out["ranked"][name]
            print(f"{name}: one rank {base['B']} lanes, median {base['median']:.6g} "
                  f"(rounds {min(base['rounds']):.6g}-{max(base['rounds']):.6g}); "
                  f"{args.ranks} ranks {row['B']} lanes, median {row['median']:.6g} "
                  f"(rounds {min(row['rounds']):.6g}-{max(row['rounds']):.6g}); ratio {r:.4g}",
                  flush=True)
        print(json.dumps(out), flush=True)
        return out
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
