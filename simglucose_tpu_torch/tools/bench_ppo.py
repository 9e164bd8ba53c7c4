"""PPO training throughput on the eager env path: bench.py's config 4 on
the XLA-path trainer.

Counterpart of ``tools/bench_ppo.py``.  It times
:func:`~simglucose_tpu_torch.rl.ppo.make_train_step` (a rollout of B
auto-resetting envs for ``rollout_steps`` on the eager env path, GAE, then
epochs x minibatches of clipped-surrogate updates with the autograd
learner) at the JAX tool's config: B=8192, ``PPOConfig(rollout_steps=64,
epochs=2, minibatches=4)``, the default tanh 7-128-128 policy, random
initial BG.  ``N_ITERS`` iterations a round after one warm-up iteration;
the best of two rounds counts, timed by
:class:`~simglucose_tpu_torch.utils.profiling.Throughput` (the card
synchronized at both ends).

Usage: ``python -m simglucose_tpu_torch.tools.bench_ppo``.
Prints one JSON line with the JAX tool's keys::

  {"metric": "ppo_env_steps_per_sec", "value": N, "unit": "steps/s",
   "iters_per_sec": N, "batch": B, "rollout_steps": T}
"""
from __future__ import annotations

import json
import math

import torch

B = 8192
T = 64
N_ITERS = 8


def main(batch: int = B, rollout_steps: int = T, n_iters: int = N_ITERS, hidden: int = 128,
         device="cuda") -> dict:
    """Run the bench and return the printed record; the arguments cut it
    for tests."""
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import PPOConfig, TrainState, make_optimizer, make_train_step
    from simglucose_tpu_torch.utils.profiling import Throughput

    device = check_device(device)
    cfg, env_params = make_env(cohort_names(batch), batch=True, random_init_bg=True,
                               dtype=torch.float32, device=device)
    env_state, reset_res = batch_reset(cfg, env_params, env_keys(0, batch, device=device))
    ppo_cfg = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4)
    policy = init_policy(torch.Generator().manual_seed(1), hidden=hidden,
                         init_log_std=ppo_cfg.init_log_std, device=device)
    ts = TrainState(params=policy, opt_state=make_optimizer(ppo_cfg).init(policy),
                    env_state=env_state, prev_res=reset_res,
                    key=env_keys((0, 1), batch, device=device),
                    generator=torch.Generator().manual_seed(2))
    step = make_train_step(ppo_cfg, cfg)

    ts, m = step(env_params, ts)  # warm-up
    best = 0.0
    for _ in range(2):
        meter = Throughput(batch, rollout_steps * n_iters, device=device)
        meter.start()
        for _ in range(n_iters):
            ts, m = step(env_params, ts)
        meter.stop()
        final = float(m["reward_mean"])
        assert math.isfinite(final), final
        best = max(best, n_iters / meter.elapsed)
    out = {
        "metric": "ppo_env_steps_per_sec",
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
