#!/usr/bin/env python3
"""Where the time goes in the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 profile_cohort.py              # every case, each in a fresh process
    python3 profile_cohort.py sim30        # one case

Cases:

* ``sim30``: ``simulate_cohort(device="cuda")``, the 30 reference patients
  x 24 h, BB, random meals;
* ``sim128x9d``: 128 patients x 9 days, BB, random meals (two calls);
* ``headline``: one ``rollout`` call at B=4096, T=4096, PID, auto-reset;
* ``fused``: one fused PPO training iteration at bench.py's config
  (B=8192, T=64, 2 epochs x 4 minibatches of 2048-row shuffle blocks, a
  relu 7-64-64 policy) on the ``kernel_prep`` path, each call continuing
  the last one's state;
* ``plane_step``, ``plane_epoch``, ``plane_autograd``: the same iteration
  on the observation-plane path (``kernel_prep=False``) with the learner
  ``pallas_learner='step'`` (K4 per minibatch), ``'epoch'`` (K5) or
  ``False`` (autograd of the loss);
* ``eval4096``: ``evaluate_policy_kernel`` of the residual-BB checkpoint
  over 4096 lanes x 24 h (seed 5), the evaluation path's paired run;
* ``sim30_eager``: ``sim30``'s run on the eager env path
  (``engine='xla'``), cut to 2 h (40 steps) so that its trace of ~2400
  launches a step stays small;
* ``train_rollout``: 4 steps of ``rl/ppo.py::make_train_step``'s rollout
  at tools/bench_ppo.py's config (B=8192 on the eager env with random
  initial BG and auto-reset, a tanh 7-128-128 policy sampling its actions),
  each call continuing the last one's state: the trainer's part that is
  not the learner.

Each case runs once to warm up, three times untraced (host clock around a
synchronised run), then once under ``torch.profiler`` (CPU and CUDA
activities).  From the traced run it prints one JSON line: the untraced
wall times, the traced wall time, the device-busy time (the union of the
card's kernel and copy intervals) and its share of the traced wall time,
the count of device events (kernels and copies), and the device time by
kernel name.  A case whose trace holds no device
event fails.  Imports nothing of JAX, pandas or matplotlib.
"""
import json
import os
import subprocess
import sys
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.abspath(__file__))
# the fused cases: (PPOConfig.pallas_learner, kernel_prep)
FUSED = {"fused": (True, True), "plane_step": ("step", False), "plane_epoch": ("epoch", False),
         "plane_autograd": (False, False)}
CASES = ("sim30", "sim128x9d", "headline", *FUSED, "eval4096", "sim30_eager", "train_rollout")


def _case_fn(case):
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    if case == "sim30":
        return lambda: simulate_cohort(sim_time=timedelta(days=1), scenario_seed=1, cgm_seed=2, device="cuda")
    if case == "sim30_eager":
        return lambda: simulate_cohort(sim_time=timedelta(hours=2), scenario_seed=1, cgm_seed=2,
                                       engine="xla", device="cuda")
    if case == "sim128x9d":
        names = tables.cohort_names(128)
        return lambda: simulate_cohort(sim_time=timedelta(days=9), patient_names=names, scenario_seed=4,
                                       cgm_seed=5, device="cuda")
    if case == "headline":
        p = tables.load_patient_params(tables.cohort_names(4096), device="cuda")
        packed = tr.pack_params(p, basal_rate(p))
        cfg = tr.RolloutConfig(n_steps=4096, controller="pid")
        return lambda: tr.rollout(cfg, packed, (1, 0))
    if case in FUSED:
        import torch

        from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_step
        from simglucose_tpu_torch.rl.policy import init_policy
        from simglucose_tpu_torch.rl.ppo import PPOConfig, make_optimizer

        B = 8192
        p = tables.load_patient_params(tables.cohort_names(B), device="cuda")
        packed = tr.pack_params(p, basal_rate(p))
        learner, kernel_prep = FUSED[case]
        cfg = PPOConfig(rollout_steps=64, epochs=2, minibatches=4, pallas_learner=learner,
                        shuffle_block=2048)
        g = torch.Generator().manual_seed(0)
        policy = init_policy(g, hidden=64, act="relu", init_mu_bias=-2.2, device="cuda")
        state = [init_fused_state(policy, make_optimizer(cfg).init(policy), B, g)]
        step = make_fused_train_step(cfg, B, hidden=64, kernel_prep=kernel_prep)

        def one_iteration():
            state[0], _ = step(packed, state[0])

        return one_iteration
    if case == "eval4096":
        from simglucose_tpu_torch.rl import evaluate as ev
        from simglucose_tpu_torch.rl import policy as pol

        resid = pol.load_policy_npz(os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_residual_bb.npz"),
                                    device="cuda", act="relu", action_scale=1.1, decoder="residual_bb")
        names = tables.cohort_names(4096)
        return lambda: ev.evaluate_policy_kernel(resid, names, hours=24.0, seed=5)
    if case == "train_rollout":
        import dataclasses

        import torch

        from simglucose_tpu_torch.envs.build import make_env
        from simglucose_tpu_torch.envs.rollout import batch_reset
        from simglucose_tpu_torch.ops.streams import env_keys
        from simglucose_tpu_torch.rl import ppo
        from simglucose_tpu_torch.rl.policy import init_policy

        B = 8192
        env_cfg, env_params = make_env(tables.cohort_names(B), batch=True, random_init_bg=True,
                                       device="cuda")
        env_state, res = batch_reset(env_cfg, env_params, env_keys(0, B, device="cuda"))
        policy = init_policy(torch.Generator().manual_seed(1), device="cuda")
        cfg = dataclasses.replace(ppo.PPOConfig(), rollout_steps=4)
        basal = basal_rate(env_params.patient)
        carry = [env_state, res, res.observation.CGM, torch.zeros_like(basal), 0]
        key = env_keys((0, 1), B, device="cuda")

        def rollout_steps():
            state, last, cgm_prev, iob, _ = ppo._rollout(cfg, env_cfg, env_params, policy,
                                                        *carry[:4], basal, key, carry[4])
            carry[:] = [state, last, cgm_prev, iob, carry[4] + cfg.rollout_steps]

        return rollout_steps
    raise SystemExit(f"unknown case {case!r}; cases: {', '.join(CASES)}")


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def run_case(case):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: profile_cohort.py runs on a machine with an NVIDIA GPU")
    fn = _case_fn(case)

    def timed():
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - tic

    timed()  # warm-up: the kernel's build and first launch
    walls = [timed() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = timed()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit(f"{case}: the trace holds no device event")
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "case": case, "wall_s_untraced": walls, "wall_s_traced": traced,
        "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e6 / traced, "device_events": len(dev),
        "device_ms_by_name": {k[:60]: v / 1e3 for k, v in top},
    }), flush=True)


def main(argv):
    sys.path.insert(0, ROOT)
    if argv:
        for case in argv:
            run_case(case)
        return
    from simglucose_tpu_torch.core.device import card_label

    print(card_label(0), flush=True)
    for case in CASES:  # a fresh process each: one profiler session per process
        subprocess.run([sys.executable, os.path.abspath(__file__), case], check=True, timeout=900)


if __name__ == "__main__":
    main(sys.argv[1:])
