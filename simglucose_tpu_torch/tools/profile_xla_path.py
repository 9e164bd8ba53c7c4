"""Ablation profile of the eager env path's rollout.

Counterpart of ``tools/profile_xla_path.py`` (the XLA engine,
``engine='xla'``), on the port's eager env path.  It measures what each
step component costs by turning it off, at B=4096 envs, PID, random
initial BG, ``T`` steps a call, ``n_calls`` calls that carry the state
after a warm-up call, timed by
:class:`~simglucose_tpu_torch.utils.profiling.Throughput` (the card
synchronized at both ends):

  base       the full PID config (native noise, random scenario, auto-reset)
  noise_off  exogenous zero noise (no AR(1)/Johnson chain)
  scen_none  ``scenario_mode='none'`` (no daily-plan draw)
  both_off   both of the above
  fixedhz    the fixed-horizon rollout (no auto-reset branch)

Usage: ``python -m simglucose_tpu_torch.tools.profile_xla_path``.  Prints
one JSON line of env-steps/s per variant, as the JAX tool does.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

B = 4096
T = 256
N_CALLS = 8


def measure(batch: int, steps: int, n_calls: int, device, env_kwargs=None,
            fixed: bool = False) -> float:
    """Env-steps/s of one variant."""
    from simglucose_tpu_torch.controllers.functional import pid_controller
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_continue_fn,
        make_batch_rollout_fn,
    )
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.utils.profiling import Throughput

    cfg, params = make_env(cohort_names(batch), batch=True, random_init_bg=True,
                           dtype=torch.float32, device=device, **(env_kwargs or {}))
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7, device=device)
    state, last = batch_reset(cfg, params, env_keys(0, batch, device=device))
    cs = broadcast_ctrl_state(ctrl0, batch)
    if fixed:
        run0 = make_batch_continue_fn(cfg, ctrl, steps)

        def run(params, state, cs, last):
            s, _, l, traj = run0(params, state, cs, last)
            return s, l, traj
    else:
        run = make_batch_rollout_fn(cfg, ctrl, n_steps=steps)

    state, last, traj = run(params, state, cs, last)  # warm-up
    meter = Throughput(batch, steps, device=device)
    meter.start()
    for _ in range(n_calls):
        state, last, traj = run(params, state, cs, last)
    meter.stop(calls=n_calls)
    assert all(math.isfinite(r) for r in traj.reward[-1].tolist()), "reward not finite"
    return meter.steps_per_sec


def main(batch: int = B, steps: int = T, n_calls: int = N_CALLS, device="cuda") -> dict:
    """Measure every variant and return the printed JSON record; the
    arguments cut the run for tests."""
    from simglucose_tpu_torch.core.device import check_device

    device = check_device(device)
    zero_noise = np.zeros(steps * (n_calls + 1) * 4 + 64, np.float32)
    variants = {
        "base": dict(),
        "noise_off": dict(env_kwargs=dict(noise_seq=zero_noise)),
        "scen_none": dict(env_kwargs=dict(scenario_mode="none")),
        "both_off": dict(env_kwargs=dict(noise_seq=zero_noise, scenario_mode="none")),
        "fixedhz": dict(fixed=True),
    }
    out = {name: round(measure(batch, steps, n_calls, device, **kw))
           for name, kw in variants.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
