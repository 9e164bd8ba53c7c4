"""Throughput of the eager env path's rollouts: the fixed horizon and the
auto-reset rollout.

Counterpart of ``tools/bench_xla_paths.py``, whose engine is the XLA scan
(``engine='xla'``); here it is the port's eager env path.  B=4096 envs, PID
(P=-1e-4, I=-1e-7), random initial BG, ``T`` steps a call, ``n_calls``
calls after a warm-up call, timed by
:class:`~simglucose_tpu_torch.utils.profiling.Throughput` (the card
synchronized at both ends):

* ``fixed_streaming``: :func:`~simglucose_tpu_torch.envs.rollout.rollout_batch`
  from minute 600 (``simulate()``'s eager engine, the streams drawn step
  by step);
* ``autoreset``: :func:`~simglucose_tpu_torch.envs.rollout.make_batch_rollout_fn`
  (the RL path), every call from the same state.

The JAX tool's ``fixed_pregen`` (``rollout(pregen=True)``) and
``autoreset K=16/64`` (``reset_cadence``) are speed options of the XLA
scan on ROADMAP's "Not ported" list: they print as not ported, with that
reason, and are not measured.

Usage: ``python -m simglucose_tpu_torch.tools.bench_xla_paths [all|fixed|autoreset]``.
It prints the JAX tool's lines, then one JSON line of env-steps/s by
variant.
"""
from __future__ import annotations

import json
import math
import sys

import torch

B = 4096
T = 256
N_CALLS = 8
NOT_PORTED = {
    "fixed_pregen": "not ported: rollout(pregen=True) is a speed option of the XLA scan "
                    "(ROADMAP 'Not ported')",
    "autoreset_K16": "not ported: reset_cadence is a speed option of the XLA scan "
                     "(ROADMAP 'Not ported')",
    "autoreset_K64": "not ported: reset_cadence is a speed option of the XLA scan "
                     "(ROADMAP 'Not ported')",
}


def _steps_per_sec(call, batch: int, steps: int, n_calls: int, device) -> float:
    from simglucose_tpu_torch.utils.profiling import Throughput

    out = call()  # warm-up
    meter = Throughput(batch, steps, device=device)
    meter.start()
    for _ in range(n_calls):
        out = call()
    meter.stop(calls=n_calls)
    assert math.isfinite(float(out.reward[-1].reshape(-1)[0])), "reward not finite"
    return meter.steps_per_sec


def _pid_env(batch: int, device, **env_kw):
    from simglucose_tpu_torch.controllers.functional import pid_controller
    from simglucose_tpu_torch.envs.build import cohort_names, make_env

    cfg, params = make_env(cohort_names(batch), batch=True, random_init_bg=True,
                           dtype=torch.float32, device=device, **env_kw)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7, device=device)
    return cfg, params, ctrl0, ctrl


def bench_fixed(batch: int, steps: int, n_calls: int, device) -> float:
    from simglucose_tpu_torch.envs.rollout import rollout_batch
    from simglucose_tpu_torch.ops.streams import env_keys

    cfg, params, ctrl0, ctrl = _pid_env(batch, device)
    keys = env_keys(0, batch, device=device)

    def call():
        return rollout_batch(cfg, params, keys, ctrl0, ctrl, steps, start_min=600)[2]

    return _steps_per_sec(call, batch, steps, n_calls, device)


def bench_autoreset(batch: int, steps: int, n_calls: int, device) -> float:
    from simglucose_tpu_torch.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )
    from simglucose_tpu_torch.ops.streams import env_keys

    cfg, params, ctrl0, ctrl = _pid_env(batch, device)
    state, reset_res = batch_reset(cfg, params, env_keys(0, batch, device=device))
    cs = broadcast_ctrl_state(ctrl0, batch)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=steps)
    return _steps_per_sec(lambda: run(params, state, cs, reset_res)[2], batch, steps, n_calls,
                          device)


def main(argv=None, batch: int = B, steps: int = T, n_calls: int = N_CALLS,
         device="cuda") -> dict:
    """Run the variants ``argv`` names (default all) and return the
    printed JSON record; the other arguments cut the run for tests."""
    from simglucose_tpu_torch.core.device import check_device

    argv = sys.argv[1:] if argv is None else list(argv)
    which = argv[0] if argv else "all"
    device = check_device(device)
    out = {}

    def row(name, value, label=None):
        out[name] = value
        shown = f"{value / 1e6:.2f}M steps/s" if isinstance(value, float) else value
        print(f"{(label or name) + ':':16s} {shown}", flush=True)

    if which in ("all", "fixed"):
        row("fixed_streaming", bench_fixed(batch, steps, n_calls, device))
        row("fixed_pregen", NOT_PORTED["fixed_pregen"])
    if which in ("all", "autoreset"):
        row("autoreset", bench_autoreset(batch, steps, n_calls, device))
        for k in (16, 64):
            row(f"autoreset_K{k}", NOT_PORTED[f"autoreset_K{k}"], f"autoreset K={k:3d}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
