"""Train the fused-PPO glucose controller at cohort scale on the card and
keep the best checkpoint.

Counterpart of ``tools/train_ppo_tpu.py``.  The training loop is
:func:`~simglucose_tpu_torch.rl.fused.make_fused_train_loop` at B=8192,
H=64 (relu), T=64, 2 epochs x 4 minibatches of 2048-row shuffle blocks, on
the ``kernel_prep`` path: the rollout kernel K1b emits the learner's rows,
the GAE kernel K2 packs advantages and returns, and the grad-step kernel
K3 (with its block sums) runs each minibatch.  It trains the continuing
task (no auto-reset, no GAE terminals) on :func:`make_hypo_weighted_reward`.

Every ``PPO_EVAL_EVERY`` blocks the current policy is evaluated with its
mean action on the 30 reference patients for 24 h at seed 999, after the
basal-bolus baseline at the same seed; the checkpoint with the lowest
cohort risk index is written with :func:`~simglucose_tpu_torch.utils.
checkpoint.save_state`, one that dominates BB (lower RI, TIR within 1 %,
hypo no worse) first.  The policy runs on the rollout kernel K1b
(:func:`~simglucose_tpu_torch.rl.evaluate.evaluate_policy_kernel`) and BB
on K1a, so both see the same meals and sensor noise at one seed; the JAX
tool pairs them on its XLA env path.

Usage::

    python -m simglucose_tpu_torch.tools.train_ppo [n_blocks] [iters_per_block]

The ``PPO_*`` environment variables of the JAX tool apply.  The checkpoint
goes to ``PPO_CKPT``, by default
``examples/checkpoints/ppo_cohort_relu64_torch.npz`` (an ignored file; the
committed checkpoints are the JAX tool's).  It prints one JSON line: the
JAX tool's keys (``iters``, ``env_steps``, ``wall_s``, ``ri_start``,
``ri_best``, ``ckpt``) and the port's ``train_ms_per_iter`` (the training
loop alone, the card synchronized; after the first block, which pays the
first launches, where there are more) and ``eval_s`` (every evaluation).
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B = 8192
HIDDEN = 64
T = 64
DEFAULT_CKPT = os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_relu64_torch.npz")
EVAL_SEED = 999


def make_hypo_weighted_reward(hypo_w: float = 3.0, barrier_w: float = 0.15,
                              rew_scale: float = 1.0):
    """The JAX tool's ``hypo_weighted_reward`` (``tools/train_ppo_tpu.py:
    163-172``): the Magni risk with its hypo branch weighted ``hypo_w``
    times, a soft barrier below 90 mg/dL, clipped at 400, from the CGM
    plane ``traj["CGM"]`` ``[T, B]``.  The Magni risk is nearly symmetric,
    so a symmetric objective lets the learner trade hypo for hyper; the
    barrier keeps a slope where the CGM clamp at 39 flattens the risk."""
    from simglucose_tpu_torch.analysis.risk import risk_scalar

    def hypo_weighted_reward(traj):
        cgm = traj["CGM"]
        lb, hb, _ = risk_scalar(cgm)
        barrier = barrier_w * torch.clamp(90.0 - cgm, min=0.0)
        return rew_scale * (-torch.clamp(hb + hypo_w * lb, max=400.0) / 10.0 - barrier)

    return hypo_weighted_reward


def cohort_eval(params, hours: float = 24.0, seed: int = EVAL_SEED, device="cuda") -> dict:
    """The current policy's mean action on the 30 reference patients
    (K1b), the action decoder read from the params."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.rl.evaluate import evaluate_policy_kernel

    return evaluate_policy_kernel(params, tables.patient_names(), hours=hours, seed=seed,
                                  device=device)


def _env(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def ppo_config(rollout_steps: int = T):
    """The JAX tool's PPOConfig, its knobs read from ``PPO_*``."""
    from simglucose_tpu_torch.rl.ppo import PPOConfig

    decoder = os.environ.get("PPO_DECODER", "sigmoid")
    return PPOConfig(
        rollout_steps=rollout_steps, epochs=2, minibatches=4,
        ent_coef=_env("PPO_ENT", 1e-3), lr=_env("PPO_LR", 3e-4),
        gamma=_env("PPO_GAMMA", 0.99), decoder=decoder,
        init_log_std=_env("PPO_INIT_LOG_STD", -0.5),
        # action = sigmoid(raw) * action_scale * patient basal: 10x the
        # patient's basal covers BB-bolus intensity; the -2.2 cold-start
        # bias lands the first action near 1x basal
        action_scale=_env("PPO_ACTION_SCALE", 10.0),
        scale_by_basal=decoder == "sigmoid",
        # insulin acts with a 30-60 min lag: gamma*lam keeps an overdose's
        # hypo inside the GAE credit horizon
        lam=_env("PPO_LAM", 0.98),
        pallas_learner=True,
        shuffle_block=2048,
    )


def initial_policy(cfg, hidden: int, seed: int = 0, device="cuda"):
    """The fresh relu policy of a run with ``PPO_SEED`` ``seed`` and the
    decoder of ``cfg``."""
    from simglucose_tpu_torch.rl.policy import init_policy

    return init_policy(
        torch.Generator().manual_seed(2 * seed + 1), hidden=hidden, act="relu",
        init_log_std=cfg.init_log_std,
        # residual_bb: zero mean bias, the fresh policy is basal-bolus
        # therapy; sigmoid: a safe under-dosed start
        init_mu_bias=0.0 if cfg.decoder == "residual_bb" else -2.2,
        action_scale=cfg.action_scale, scale_by_basal=cfg.scale_by_basal,
        decoder=cfg.decoder, device=device,
    )


def main(argv=None, batch: int = B, hidden: int = HIDDEN, rollout_steps: int = T,
         eval_hours: float = 24.0, device="cuda") -> dict:
    """Train ``n_blocks`` x ``iters_per_block`` iterations (``argv``, by
    default 300 and 8) and return the printed summary.  ``batch``,
    ``hidden``, ``rollout_steps``, ``eval_hours`` and ``device`` cut the
    run for tests."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params
    from simglucose_tpu_torch.rl.evaluate import evaluate_controller
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu_torch.rl.ppo import make_optimizer
    from simglucose_tpu_torch.utils.checkpoint import restore_state, save_state
    from simglucose_tpu_torch.utils.profiling import Throughput

    argv = sys.argv[1:] if argv is None else list(argv)
    n_blocks = int(argv[0]) if len(argv) > 0 else 300
    # 8 iterations x 64 steps x 3 min = 25.6 simulated hours per block:
    # fresh episodes every block (init=1), eval-horizon-scale training
    iters_per_block = int(argv[1]) if len(argv) > 1 else 8
    device = check_device(device)
    ckpt = os.environ.get("PPO_CKPT") or DEFAULT_CKPT

    names = tables.cohort_names(batch)
    patient = tables.load_patient_params(names, device=device)
    # the residual_bb decoder reads the Quest CR/CF planes in the kernel;
    # they are packed for every decoder (sigmoid ignores them)
    packed = pack_params(patient, basal_rate(patient),
                         quest=tables.load_quest_params(names, device=device))
    seed = int(os.environ.get("PPO_SEED", 0))
    cfg = ppo_config(rollout_steps)
    policy = initial_policy(cfg, hidden, seed, device)
    # critic warm init: the continuing task's steady-state value is about
    # mean_reward / (1 - gamma*lam)
    init_bv = os.environ.get("PPO_INIT_BV")
    if init_bv is not None:
        policy = policy.replace(b_v=torch.full_like(policy.b_v, float(init_bv)))
    warm = os.environ.get("PPO_WARM_START")
    if warm:
        policy = restore_state(warm, like=policy)
        # warm-starting into a larger action_scale S' from S keeps the
        # low-dose policy by shifting the mean bias: raw' = raw - ln(S'/S)
        shift = _env("PPO_BMU_SHIFT", 0.0)
        if shift:
            policy = policy.replace(b_mu=policy.b_mu + shift)
        print(f"warm start from {warm} (b_mu shift {shift:+.2f})", flush=True)
    ts = init_fused_state(policy, make_optimizer(cfg).init(policy), batch,
                          torch.Generator().manual_seed(2 * seed))
    # the continuing task: an excursion keeps collecting its own rewards
    # (the episodic form invites reset farming)
    reward_fn = make_hypo_weighted_reward(_env("PPO_HYPO_W", 3.0), _env("PPO_BARRIER", 0.15),
                                          _env("PPO_REW_SCALE", 1.0))
    loop = make_fused_train_loop(cfg, batch, iters_per_block, hidden=hidden,
                                 reward_kind="neg_risk", continuing=True, reward_fn=reward_fn)

    # BB-dominance selection: BB at the same seed is the bar; prefer
    # checkpoints that dominate it, the best RI among those
    eval_s = 0.0

    def timed_eval(fn):
        nonlocal eval_s
        tic = time.perf_counter()
        res = fn()
        eval_s += time.perf_counter() - tic
        return res

    bb = timed_eval(lambda: evaluate_controller("BB", tables.patient_names(), hours=eval_hours,
                                                seed=EVAL_SEED, device=device))
    bb_ri = float(bb["risk_index"].mean())
    bb_tir = float(bb["percent_in_70_180"].mean())
    bb_hypo = float(bb["percent_below_70"].mean())
    print(f"BB baseline (seed {EVAL_SEED}): RI {bb_ri:.3f} TIR {bb_tir:.1f}% "
          f"hypo {bb_hypo:.2f}%", flush=True)

    best_ri, best_dom = float("inf"), False
    r0 = timed_eval(lambda: cohort_eval(policy, eval_hours, device=device))
    ri0 = float(r0["risk_index"].mean())
    print(f"iter 0: cohort RI {ri0:.3f} TIR {r0['percent_in_70_180'].mean():.1f}%", flush=True)

    eval_every = int(os.environ.get("PPO_EVAL_EVERY", 10))
    # the first block (which pays the kernels' first launches) and the rest
    meters = [Throughput(batch, rollout_steps * iters_per_block, device=device) for _ in range(2)]
    tic = time.time()
    for blk in range(n_blocks):
        # fresh episodes each block: new start hours, initial BG, meal plans
        ts = ts._replace(init=1)
        meters[min(blk, 1)].start()
        ts, m = loop(packed, ts)
        meters[min(blk, 1)].stop()
        i = (blk + 1) * iters_per_block
        if (blk + 1) % eval_every and blk + 1 != n_blocks:
            continue
        rew, done, ent = (float(m[k][-1]) for k in ("reward_mean", "done_frac", "entropy"))
        res = timed_eval(lambda: cohort_eval(ts.params, eval_hours, device=device))
        ri = float(res["risk_index"].mean())
        tir = float(res["percent_in_70_180"].mean())
        hypo = float(res["percent_below_70"].mean())
        dom = ri < bb_ri and tir >= bb_tir - 1.0 and hypo <= bb_hypo
        marker = ""
        if (dom and not best_dom) or (dom == best_dom and ri < best_ri):
            best_ri, best_dom = ri, dom
            save_state(ckpt, ts.params)
            marker = "  <- checkpoint" + (" (dominates BB)" if dom else "")
        print(f"iter {i:5d}: train rew {rew:+.4f} done {done:.4f} ent {ent:.3f}"
              f" | cohort RI {ri:.3f} TIR {tir:.1f}% hypo {hypo:.2f}%{marker}", flush=True)
    wall = time.time() - tic
    iters = n_blocks * iters_per_block
    steady = meters[1] if meters[1].calls else meters[0]
    out = {
        "iters": iters,
        "env_steps": iters * batch * rollout_steps,
        "wall_s": round(wall, 1),
        "ri_start": ri0,
        "ri_best": best_ri,
        "ckpt": os.path.abspath(ckpt),
        "train_ms_per_iter": steady.elapsed / (steady.calls * iters_per_block) * 1e3,
        "eval_s": eval_s,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
