"""Fused PPO training throughput: bench.py's config 4 on the rollout kernel.

Counterpart of ``tools/bench_ppo_fused.py``.  It times the fused PPO
iteration (:mod:`simglucose_tpu_torch.rl.fused`: the rollout kernel K1b
with the policy MLP inside, then the learner) at the JAX tool's config:
B=8192, T=64, relu 7-64-64, mu bias -2.2, ``PPOConfig(rollout_steps=64,
epochs=2, minibatches=4)``, which is the observation-plane path with the
autograd learner.  Each round runs ``N_ITERS`` iterations
(:func:`~simglucose_tpu_torch.rl.fused.make_fused_train_loop`) after one
warm-up round; the best of two rounds counts, timed by
:class:`~simglucose_tpu_torch.utils.profiling.Throughput` (the card
synchronized at both ends).

Usage: ``python -m simglucose_tpu_torch.tools.bench_ppo_fused``.  Prints
one JSON line with the JAX tool's keys::

  {"metric": "fused_ppo_env_steps_per_sec", "value": N, "unit": "steps/s",
   "iters_per_sec": N, "batch": B, "rollout_steps": T}
"""
from __future__ import annotations

import json
import math

import torch

B = 8192
T = 64
N_ITERS = 32
HIDDEN = 64


def main(batch: int = B, rollout_steps: int = T, n_iters: int = N_ITERS, hidden: int = HIDDEN,
         device="cuda") -> dict:
    """Run the bench and return the printed record; the arguments cut it
    for tests."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    from simglucose_tpu_torch.utils.profiling import Throughput

    device = check_device(device)
    patient = tables.load_patient_params(tables.cohort_names(batch), device=device)
    packed = pack_params(patient, basal_rate(patient))
    cfg = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4)
    policy = init_policy(torch.Generator().manual_seed(1), hidden=hidden, act="relu",
                         init_log_std=cfg.init_log_std, init_mu_bias=-2.2, device=device)
    ts = init_fused_state(policy, make_optimizer(cfg).init(policy), batch,
                          torch.Generator().manual_seed(0))
    loop = make_fused_train_loop(cfg, batch, n_iters, hidden=hidden)

    ts, m = loop(packed, ts)  # warm-up: builds and loads the kernels
    best = 0.0
    for _ in range(2):
        meter = Throughput(batch, rollout_steps * n_iters, device=device)
        meter.start()
        ts, m = loop(packed, ts)
        meter.stop()
        final = float(m["reward_mean"][-1])
        assert math.isfinite(final), final
        best = max(best, n_iters / meter.elapsed)
    out = {
        "metric": "fused_ppo_env_steps_per_sec",
        "value": round(best * batch * rollout_steps),
        "unit": "steps/s",
        "iters_per_sec": round(best, 3),
        "batch": batch,
        "rollout_steps": rollout_steps,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
