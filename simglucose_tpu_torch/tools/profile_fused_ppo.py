"""Device-time breakdown of one fused-PPO iteration.

Counterpart of ``tools/profile_fused_ppo.py``.  It times
:func:`~simglucose_tpu_torch.rl.fused.make_fused_train_loop` in the cut
variants of ``make_fused_train_step(stages=...)`` to decompose an
iteration at B=8192, T=64, relu 7-64-64:

  rollout          the rollout kernel K1b and the state carry
  forward          + the features, the log-prob / value forward, GAE
  full             the training step
  learner          = full - forward (epochs x minibatch grad steps)
  fwd+GAE          = forward - rollout

for the JAX tool's base config (the observation-plane path, autograd
learner), the grad-step learner on the plane path, and the ``kernel_prep``
path (K1b emits the learner rows, K2, K3), plus (without ``quick``) the
learner-shape grid ((epochs, minibatches) of (1, 4), (2, 1), (1, 1)).  The
JAX tool's ``t_chunk`` rows are a TPU VMEM knob, on ROADMAP's "Not ported"
list: they are printed as not ported, not measured.

Each variant runs one warm-up call of ``iters`` iterations and two timed
calls; the shorter counts.  On the card a call is timed by CUDA events
around it; on the CPU by the host clock.

Usage: ``python -m simglucose_tpu_torch.tools.profile_fused_ppo [quick]``.
It prints the JAX tool's lines, then one JSON line of ms per iteration by
the JAX tool's row names.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

B = 8192
T = 64
ITERS = 128
HIDDEN = 64
NOT_PORTED = "not ported: t_chunk is a TPU VMEM knob (ROADMAP 'Not ported')"


def call_ms(fn, device) -> float:
    """Milliseconds of ``fn()``: CUDA events around it on the card (the
    card's time from the first launch to the last), the host clock on the
    CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    tic = time.perf_counter()
    fn()
    return (time.perf_counter() - tic) * 1e3


def main(argv=None, batch: int = B, rollout_steps: int = T, iters: int = ITERS,
         hidden: int = HIDDEN, device="cuda") -> dict:
    """Run the breakdown and return ``{row: ms per iteration}`` (the
    printed JSON); ``argv`` ``['quick']`` skips the learner-shape grid; the
    other arguments cut the run for tests."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import PPOConfig, make_optimizer

    argv = sys.argv[1:] if argv is None else list(argv)
    quick = bool(argv) and argv[0] == "quick"
    device = check_device(device)
    patient = tables.load_patient_params(tables.cohort_names(batch), device=device)
    packed = pack_params(patient, basal_rate(patient))
    base = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4)
    rows = {}

    def run(tag, cfg, stages, **kw):
        policy = init_policy(torch.Generator().manual_seed(1), hidden=hidden, act="relu",
                             init_log_std=cfg.init_log_std, init_mu_bias=-2.2, device=device)
        state = [init_fused_state(policy, make_optimizer(cfg).init(policy), batch,
                                  torch.Generator().manual_seed(0))]
        loop = make_fused_train_loop(cfg, batch, iters, hidden=hidden, stages=stages, **kw)

        def once():
            state[0], m = loop(packed, state[0])
            return m

        once()  # warm-up: builds and loads the kernels
        ms = min(call_ms(once, device) for _ in range(2)) / iters
        rows[tag] = ms
        print(f"{tag:40s} {ms:7.3f} ms/iter ({batch * rollout_steps / ms * 1e3 / 1e6:8.1f} "
              f"M steps/s)", flush=True)
        return ms

    pal = dataclasses.replace(base, pallas_learner=True, shuffle_block=2048)
    ms_roll = run("rollout (kernel only)", base, "rollout")
    ms_fwd = run("rollout+forward+GAE", base, "forward")
    ms_full = run("full (e=2, mb=4)", base, "full")
    print(f"{'-> fwd+GAE':40s} {ms_fwd - ms_roll:7.3f} ms")
    print(f"{'-> learner (8 grad steps)':40s} {ms_full - ms_fwd:7.3f} ms")
    run("full pallas learner (plane prep)", pal, "full", kernel_prep=False)
    # the kernel_prep pipeline: learner rows emitted by the rollout kernel;
    # only GAE and the adv/ret pack between the two kernels
    ms_kroll = run("kprep rollout (emit rows)", pal, "rollout")
    ms_kfwd = run("kprep rollout+GAE", pal, "forward")
    ms_kfull = run("kprep full", pal, "full")
    print(f"{'-> kprep GAE+pack':40s} {ms_kfwd - ms_kroll:7.3f} ms")
    print(f"{'-> kprep learner (8 grad steps)':40s} {ms_kfull - ms_kfwd:7.3f} ms")
    for tc in (4, 16):
        rows[f"kprep full t_chunk={tc}"] = NOT_PORTED
        print(f"kprep t_chunk={tc}: {NOT_PORTED}", flush=True)
    if not quick:
        ms_e1 = run("full (e=1, mb=4)", dataclasses.replace(base, epochs=1), "full")
        ms_m1 = run("full (e=2, mb=1)", dataclasses.replace(base, minibatches=1), "full")
        ms_e1m1 = run("full (e=1, mb=1)", dataclasses.replace(base, epochs=1, minibatches=1),
                      "full")
        print(f"{'-> per-epoch (shuffle+4mb)':32s} {ms_full - ms_e1:7.3f} ms")
        print(f"{'-> 6 extra minibatches':32s} {ms_full - ms_m1:7.3f} ms")
        print(f"{'-> minimal learner (1 step)':32s} {ms_e1m1 - ms_fwd:7.3f} ms")
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
