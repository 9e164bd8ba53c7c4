"""The headline benchmark on the card: env-steps/s of the closed-loop
rollout kernel at a 4096-patient batch, law-gated, and the fused-PPO
training throughput.

Counterpart of the root ``bench.py``, with its configs, timed region, law
gates and printed keys:

* :func:`bench_pallas`, the headline: K1a (``ops/rollout.py::rollout``)
  at B=4096 per card, T=4096, PID, auto-reset, Dexcom, random meals,
  float32, no Quest table.  One warm-up call (which also builds the
  kernels' library), then two rounds of ``n_calls`` back-to-back calls,
  each round opened with the card synchronized and closed by
  ``torch.cuda.synchronize()`` and a host copy of the last reward row
  (:class:`~simglucose_tpu_torch.utils.profiling.Throughput`); the best
  round counts.  The last call's trajectory is then held to the law bands
  (:func:`_check_laws`): a kernel that clamps BG, drops meals or zeroes the
  noise fails the bench instead of posting a fast wrong number.
* :func:`law_gate_other_sensors`: GuardianRT (5 min samples) and
  Navigator (1 min) at B=1024, T=576, against :data:`_SENSOR_GATE_BANDS`.
* :func:`bench_fused_ppo`: the fused PPO iteration at B=8192, T=64, 2
  epochs x 4 minibatches of 2048-row shuffle blocks, relu 7-64-64 on the
  ``kernel_prep`` path (K1b emitting the learner rows, K2, 8 x K3), timed
  over loops of 128 iterations.  The JAX loop is one scanned program; here
  it is a Python loop over the train step, whose host time per grad step
  counts in ``fused_ppo_iters_per_sec``.
* :func:`bench_xla`: the general path (the eager env of
  :mod:`simglucose_tpu_torch.envs`), run only on request (``--path xla``).

With more than one rank (``torchrun --nproc_per_node=N``, one rank per
card) the headline runs as the JAX bench's ``shard_map`` branch does: 4096
lanes per rank, every draw keyed by global lane, no communication during
the rollout; a round's time is the slowest rank's, and the law statistics
are those of the global batch.  Rank 0 alone runs the sensor gates and the
fused PPO section (JAX runs them on one device) and prints.

There is no fallback: a law violation or any other failure propagates and
the process exits non-zero.

Usage::

    python -m simglucose_tpu_torch.tools.bench [--path cuda|xla]

Prints ONE JSON line::

  {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
   "vs_baseline": N/1e6, "path": "cuda"|"xla",
   "fused_ppo_steps_per_sec": M, "fused_ppo_iters_per_sec": I,
   "fused_ppo_batch": 8192, "fused_ppo_rollout_steps": 64,
   "device": "<card name>", "power_limit": "<watts>"}

(the ``fused_ppo_*`` keys on the ``cuda`` path only; ``device`` and
``power_limit`` as ``nvidia-smi --query-gpu=name,power.limit`` gives them
for this rank's card, ``"cpu"`` and null on the CPU).  ``vs_baseline`` is
against the 1M env-steps/s north star of ``BASELINE.md``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os

import torch
import torch.distributed as dist

from simglucose_tpu_torch.core.device import card_label, check_device
from simglucose_tpu_torch.utils.profiling import Throughput

B = 4096  # lanes per card
T = 4096
N_CALLS = 24
SENSOR_B, SENSOR_T = 1024, 576
# the fused PPO config (tools/bench_ppo_fused.py's, BASELINE config 4) and
# the iterations of one timed loop
PPO_B, PPO_T, PPO_ITERS, PPO_H = 8192, 64, 128, 64
XLA_T, XLA_CALLS = 256, 8


def _assert_band(name, value, lo, hi):
    if not (lo <= value <= hi):
        raise AssertionError(
            f"law violation: {name}={value:.4g} outside [{lo}, {hi}] — the "
            f"benched kernel no longer matches the cross-validated "
            f"simulator laws (BASELINE.md)"
        )


def _law_stats(traj, sample_time=3, mesh=None):
    """Distributional stats of a PID-config rollout, as card scalars: BG
    mean, done rate, CGM-BG residual std (ddof 0, as ``jnp.std``), CHO per
    day.  ``traj`` is :func:`~simglucose_tpu_torch.ops.rollout.rollout`'s
    result.

    Two passes in float64: the sums and the count, then the squared
    deviations from the residual's mean.  With a live ``mesh`` each rank
    holds its lanes and both passes are summed over ``'dp'``, so that the
    stats are those of the global batch, equal to one process's stats of
    the same lanes."""
    from simglucose_tpu_torch.parallel.sharding import all_reduce_sum

    bg = traj["BG"]
    resid = traj["CGM"] - bg
    planes = [bg, traj["done"], resid, traj["CHO"]]
    sums = torch.stack([p.to(torch.float64).sum() for p in planes]
                       + [torch.tensor(float(bg.numel()), dtype=torch.float64, device=bg.device)])
    all_reduce_sum(sums, mesh, "dp")
    means = sums[:4] / sums[4]
    sq = ((resid.to(torch.float64) - means[2]) ** 2).sum().reshape(1)
    all_reduce_sum(sq, mesh, "dp")
    return {
        "bg_mean": means[0],
        "done_rate": means[1],
        "resid_std": torch.sqrt(sq[0] / sums[4]),
        "cho_per_day": means[3] * (sample_time * (1440 // sample_time)),
    }


# The PID headline config's invariant bands, from the round-1 kernel-vs-XLA
# cross-validation (BASELINE.md: BG mean 203.8, done rate 0.0080, CGM-BG
# residual std 11.47, CHO/day ~220 g).
_LAW_BANDS = dict(
    bg_mean=(170.0, 240.0), done_rate=(0.003, 0.020),
    resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
)


def _check_laws(stats):
    """Hold the headline's stats to :data:`_LAW_BANDS`."""
    for name, (lo, hi) in _LAW_BANDS.items():
        _assert_band(name, stats[name], lo, hi)


# Per-sensor bands of the other sample times: the sample time sets the
# noise lattice's cadence, so the bench also gates GuardianRT (st=5) and
# Navigator (st=1) rollouts at B=1024, T=576, PID, key (11, 0).  The JAX
# bench's bands (centers measured on its TPU: GuardianRT bg 207.0-207.7 /
# done 0.0141 / resid 11.5 / cho 221; Navigator bg 194.6-195.4 / done
# 0.0022 / resid 11.5 / cho 206-214).  Reference laws
# sensor/noise_gen.py:15-69.
_SENSOR_GATE_BANDS = {
    "GuardianRT": dict(
        bg_mean=(175.0, 240.0), done_rate=(0.005, 0.030),
        resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
    ),
    "Navigator": dict(
        bg_mean=(165.0, 230.0), done_rate=(0.0005, 0.010),
        resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
    ),
}


def _packed(batch: int, device):
    """The first ``batch`` patients of the cohort packed for the rollout
    kernel, with no Quest table."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params

    patient = tables.load_patient_params(tables.cohort_names(batch), device=device)
    return pack_params(patient, basal_rate(patient))


def _finite_rewards(reward):
    """The hard fetch: a host copy of the last row of the ``[T, B]``
    rewards, which must be finite."""
    final = reward[-1].cpu()
    if not torch.isfinite(final).all():
        raise AssertionError("non-finite rewards")


def _slowest(seconds: float, mesh) -> float:
    """The largest of the ranks' ``seconds`` (this rank's without a live
    mesh)."""
    from simglucose_tpu_torch.parallel.sharding import all_gather

    return float(all_gather(torch.tensor([seconds], dtype=torch.float64), mesh).max())


def _timed_rounds(run, global_batch: int, n_steps: int, n_calls: int, rounds: int, device,
                  mesh=None):
    """The bench's timed loop: ``run(seed)`` once to warm up (the first call
    builds and loads the kernels), then ``rounds`` rounds of ``n_calls``
    back-to-back calls, call ``i`` of round ``r`` at key ``(r * n_calls + i
    + 1, 0)``.  Each round opens with the card synchronized (after a barrier
    of the ranks) and closes with ``torch.cuda.synchronize()`` and the host
    copy of the last reward row; it holds no host sync in between.  Returns
    the best round's env-steps/s over the ``global_batch`` lanes (a round
    lasts as long as its slowest rank) and the last call's trajectory."""
    _finite_rewards(run((0, 0))["reward"])
    best, traj = 0.0, None
    for r in range(rounds):
        if mesh is not None and mesh.live:
            dist.barrier()
        meter = Throughput(global_batch, n_steps, device=device)
        meter.start()
        for i in range(n_calls):
            traj = run((r * n_calls + i + 1, 0))
        meter.stop(n_calls)
        _finite_rewards(traj["reward"])
        best = max(best, global_batch * n_steps * n_calls / _slowest(meter.elapsed, mesh))
    return best, traj


def law_gate_other_sensors(batch: int = SENSOR_B, n_steps: int = SENSOR_T, device="cuda"):
    """Rollouts at st=5 (GuardianRT) and st=1 (Navigator), PID, key (11, 0),
    held to :data:`_SENSOR_GATE_BANDS`.  Returns each sensor's stats.  The
    JAX bench's TPU tiling (``block_rows``, ``t_chunk``) has no
    counterpart."""
    from simglucose_tpu_torch.ops.rollout import config_for_sensor, rollout

    device = check_device(device)
    packed = _packed(batch, device)
    out = {}
    for sensor, bands in _SENSOR_GATE_BANDS.items():
        cfg = config_for_sensor(sensor, controller="pid", n_steps=n_steps)
        traj = rollout(cfg, packed, (11, 0))
        out[sensor] = {k: float(v) for k, v in _law_stats(traj, cfg.sample_time).items()}
        for name, (lo, hi) in bands.items():
            _assert_band(f"{sensor}.{name}", out[sensor][name], lo, hi)
    return out


def bench_pallas(batch: int = B, n_steps: int = T, n_calls: int = N_CALLS, device="cuda",
                 mesh=None):
    """The headline: K1a at ``batch`` lanes per rank (see the module
    docstring).  Returns ``(env_steps_per_sec, stats)``, the best round's
    rate over every rank's lanes and the law stats of the last call (global
    under a ``mesh``), which must hold :data:`_LAW_BANDS`.

    ``mesh`` (a ``(dp, 1)`` :func:`~simglucose_tpu_torch.parallel.sharding.make_mesh`)
    runs ``batch * dp`` lanes through
    :func:`~simglucose_tpu_torch.ops.rollout.make_sharded_rollout`, each rank
    its own."""
    from simglucose_tpu_torch.ops.rollout import RolloutConfig, make_sharded_rollout, rollout
    from simglucose_tpu_torch.parallel.sharding import resolve_mesh

    device = check_device(device)
    dp = 1 if mesh is None else resolve_mesh(mesh).dp
    global_batch = batch * dp
    packed = _packed(global_batch, device)
    cfg = RolloutConfig(n_steps=n_steps, controller="pid")
    if mesh is None:
        run = functools.partial(rollout, cfg, packed)
    else:
        run = functools.partial(make_sharded_rollout(cfg, global_batch, mesh), packed)
    best, traj = _timed_rounds(run, global_batch, n_steps, n_calls, 2, device, mesh)
    stats = {k: float(v) for k, v in _law_stats(traj, cfg.sample_time, mesh).items()}
    _check_laws(stats)
    return best, stats


def _round_seconds(run, rounds: int, device, mesh=None) -> list:
    """``run()`` once to warm up (the first call builds and loads the
    kernels), then ``rounds`` timed calls, each opened with the card
    synchronized (after a barrier of the ranks under a live ``mesh``) and
    closed with it synchronized: each call's seconds, the slowest
    rank's."""
    run()
    out = []
    for _ in range(rounds):
        if mesh is not None and mesh.live:
            dist.barrier()
        meter = Throughput(1, 1, device=device)
        meter.start()
        run()
        meter.stop()
        out.append(_slowest(meter.elapsed, mesh))
    return out


def _fused_rounds(cfg, batch: int, iters: int, hidden: int, device, mesh=None,
                  rounds: int = 2) -> list:
    """Fused PPO iterations/s of ``cfg`` through
    :func:`~simglucose_tpu_torch.rl.fused.make_fused_train_loop` at the
    first ``batch`` patients of the cohort (global under a ``mesh``: each
    rank trains its rows), a relu 7-``hidden``-``hidden`` policy with mu
    bias -2.2 (policy seed 1, state seed 0): one warm-up loop of ``iters``
    iterations, then ``rounds`` timed loops (:func:`_round_seconds`), the
    rate of each.  Every metric of the last loop must be finite."""
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import make_optimizer

    device = check_device(device)
    packed = _packed(batch, device)
    policy = init_policy(torch.Generator().manual_seed(1), hidden=hidden, act="relu",
                         init_log_std=cfg.init_log_std, init_mu_bias=-2.2, device=device)
    carry = [init_fused_state(policy, make_optimizer(cfg).init(policy), batch,
                              torch.Generator().manual_seed(0), mesh=mesh), None]
    loop = make_fused_train_loop(cfg, batch, iters, hidden=hidden, mesh=mesh)

    def run():
        carry[:] = loop(packed, carry[0])

    seconds = _round_seconds(run, rounds, device, mesh)
    for k, v in carry[1].items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite metric {k}")
    return [iters / s for s in seconds]


def bench_fused_ppo(batch: int = PPO_B, rollout_steps: int = PPO_T, iters: int = PPO_ITERS,
                    hidden: int = PPO_H, device="cuda"):
    """The fused PPO iteration (BASELINE config 4) on the ``kernel_prep``
    path: 2 epochs x 4 minibatches of 2048-row shuffle blocks, each
    minibatch's grad step one K3 launch (:func:`_fused_rounds`, loops of
    ``iters`` iterations, the best of two).  Returns ``(env-steps/s,
    iterations/s)``."""
    from simglucose_tpu_torch.rl.ppo import PPOConfig

    cfg = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4, pallas_learner=True,
                    shuffle_block=2048)
    best = max(_fused_rounds(cfg, batch, iters, hidden, device))
    return best * batch * rollout_steps, best


def bench_xla(batch: int = B, n_steps: int = XLA_T, n_calls: int = XLA_CALLS, device="cuda"):
    """The general path: the eager env's batched auto-reset rollout
    (:func:`~simglucose_tpu_torch.envs.rollout.make_batch_rollout_fn`), PID
    (P=-1e-4, I=-1e-7), random initial BG, one warm-up call and ``n_calls``
    timed calls.  The JAX bench amortizes reset sampling over 16-step
    chunks (``reset_cadence``); that option is not ported, and the port
    draws the reset candidates at every step.  Returns env-steps/s."""
    from simglucose_tpu_torch.controllers.functional import pid_controller
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )
    from simglucose_tpu_torch.ops.streams import env_keys

    device = check_device(device)
    cfg, params = make_env(cohort_names(batch), batch=True, random_init_bg=True,
                           dtype=torch.float32, device=device)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7, device=device)
    state, reset_res = batch_reset(cfg, params, env_keys(0, batch, device=device))
    ctrl_state = broadcast_ctrl_state(ctrl0, batch)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=n_steps)

    state, last, traj = run(params, state, ctrl_state, reset_res)
    _finite_rewards(traj.reward)
    meter = Throughput(batch, n_steps, device=device)
    meter.start()
    for _ in range(n_calls):
        state, last, traj = run(params, state, ctrl_state, last)
    meter.stop(n_calls)
    _finite_rewards(traj.reward)
    return meter.steps_per_sec


def _card(device) -> tuple:
    """(name, power limit) of ``device``'s card as ``nvidia-smi`` gives them,
    asked by the card's UUID; ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    name, limit = (s.strip() for s in card_label(device.index).rsplit(",", 1))
    return name, limit


def main(argv=None, n_steps: int = T, n_calls: int = N_CALLS, ppo_iters: int = PPO_ITERS,
         xla_calls: int = XLA_CALLS, device="cuda"):
    """Run the bench and print its line (rank 0); returns the printed
    record (None on the other ranks).  The keyword arguments cut the
    sections' depth, the JAX bench's by default.  Under ``torchrun``
    (``WORLD_SIZE`` > 1) it joins the process group for the run; inside a
    live group of more than one rank it runs on that group."""
    from simglucose_tpu_torch.parallel.multihost import process_group
    from simglucose_tpu_torch.parallel.sharding import make_mesh

    parser = argparse.ArgumentParser(
        prog="python -m simglucose_tpu_torch.tools.bench",
        description="env-steps/s of the rollout kernel (law-gated) and fused PPO iterations/s")
    parser.add_argument("--path", choices=("cuda", "xla"), default="cuda",
                        help="cuda: the rollout kernels (default); xla: the eager env path alone")
    args = parser.parse_args(argv)
    device = check_device(device)
    join = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    with process_group() if join else contextlib.nullcontext():
        mesh = make_mesh() if dist.is_initialized() and dist.get_world_size() > 1 else None
        lead = mesh is None or mesh.rank == 0
        card = _card(device)
        out = {}
        if args.path == "xla":
            if lead:
                sps = bench_xla(n_calls=xla_calls, device=device)
        else:
            sps, _ = bench_pallas(n_steps=n_steps, n_calls=n_calls, device=device, mesh=mesh)
            if lead:
                # the other sample times' noise lattices, gated in the same process
                law_gate_other_sensors(device=device)
                fused_sps, fused_ips = bench_fused_ppo(iters=ppo_iters, device=device)
                out = {
                    "fused_ppo_steps_per_sec": round(fused_sps),
                    "fused_ppo_iters_per_sec": round(fused_ips, 3),
                    "fused_ppo_batch": PPO_B,
                    "fused_ppo_rollout_steps": PPO_T,
                }
        if mesh is not None:
            dist.barrier()
        if not lead:
            return None
        out = {
            "metric": "env_steps_per_sec",
            "value": round(sps),
            "unit": "steps/s",
            "vs_baseline": round(sps / 1e6, 3),
            "path": args.path,
            **out,
            "device": card[0],
            "power_limit": card[1],
        }
        print(json.dumps(out), flush=True)
        return out


if __name__ == "__main__":
    main()
