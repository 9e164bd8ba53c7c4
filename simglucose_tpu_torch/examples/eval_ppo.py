"""Evaluate the shipped PPO glucose-control policies against the clinical
therapy baselines (basal-bolus and PID) on the 30-patient cohort.

Counterpart of ``examples/eval_ppo.py``.  The committed checkpoints
(``examples/checkpoints/ppo_cohort_relu64.npz`` and
``ppo_cohort_residual_bb.npz``, trained by the JAX package's
``tools/train_ppo_tpu.py``) are read, never written.  Both policies run on
the rollout kernel K1b with their mean action
(:func:`~simglucose_tpu_torch.rl.evaluate.evaluate_policy_kernel`) and BB
and PID on K1a, so all four see the same meals and sensor noise at one
seed (the JAX script pairs them on its XLA env path), and are compared on
the reference's performance statistics (time in range, LBGI / HBGI / risk
index per patient; reference: examples/results/2017-12-31_17-46-32/
performance_stats.csv).

Run with ``python -m simglucose_tpu_torch.examples.eval_ppo [hours]
[seed]``; the tables need pandas.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_relu64.npz")
RESIDUAL_CKPT = os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_residual_bb.npz")


def main(hours: float = 24.0, seed: int = 1234, device="cuda") -> dict:
    """Returns each controller's per-patient statistics frame."""
    import torch

    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.rl.evaluate import (
        evaluate_controller,
        evaluate_policy_kernel,
        stats_frame,
    )
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.utils.checkpoint import restore_state

    # the static metadata states the decoder each checkpoint was trained
    # with: basal-scaled sigmoid actions, and the residual modulation of
    # basal-bolus therapy (the BB-competitive policy)
    like = init_policy(torch.Generator(), hidden=64, act="relu", action_scale=10.0,
                       scale_by_basal=True, device=device)
    policy = restore_state(CKPT, like=like)
    residual = restore_state(
        RESIDUAL_CKPT,
        like=init_policy(torch.Generator(), hidden=64, act="relu", action_scale=1.1,
                         scale_by_basal=False, decoder="residual_bb", device=device),
    )
    names = tables.patient_names()
    runs = {
        "PPO residual-BB": lambda: evaluate_policy_kernel(residual, names, hours=hours, seed=seed,
                                                          device=device),
        "PPO (absolute)": lambda: evaluate_policy_kernel(policy, names, hours=hours, seed=seed,
                                                         device=device),
        "BB therapy": lambda: evaluate_controller("BB", names, hours=hours, seed=seed,
                                                  device=device),
        "PID": lambda: evaluate_controller("PID", names, hours=hours, seed=seed, device=device),
    }
    summaries = {}
    for label, run in runs.items():
        df = stats_frame(run())
        summaries[label] = df
        print(f"\n=== {label} — {hours:.0f} h, 30-patient cohort, seed {seed} ===")
        print(df.round(3).to_string())

    print("\n=== Cohort means ===")
    for label, df in summaries.items():
        print(
            f"{label:22s} RI {df.risk_index.mean():6.3f}  "
            f"LBGI {df.LBGI.mean():5.3f}  HBGI {df.HBGI.mean():6.3f}  "
            f"TIR {df.percent_in_70_180.mean():5.1f}%  "
            f"hypo {df.percent_below_70.mean():4.2f}%  "
            f"BG {df.BG_mean.mean():5.1f}"
        )
    res_ri = summaries["PPO residual-BB"].risk_index.mean()
    bb_ri = summaries["BB therapy"].risk_index.mean()
    ppo_ri = summaries["PPO (absolute)"].risk_index.mean()
    pid_ri = summaries["PID"].risk_index.mean()
    print(
        f"\nPPO residual-BB mean risk index {res_ri:.3f} vs BB {bb_ri:.3f} "
        f"({'BEATS' if res_ri < bb_ri else 'does not beat'} the BB baseline); "
        f"absolute-decoder PPO {ppo_ri:.3f} vs PID {pid_ri:.3f} "
        f"({'BEATS' if ppo_ri < pid_ri else 'does not beat'} PID)"
    )
    return summaries


if __name__ == "__main__":
    main(*(f(a) for f, a in zip((float, int), sys.argv[1:3])))
