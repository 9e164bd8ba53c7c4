"""Fused PPO training: the actor rollout runs as one kernel.

Counterpart of ``examples/train_ppo_fused.py``.  The rollout kernel K1b
runs the env physics, the policy MLP and the action sampling for the
whole rollout (:mod:`simglucose_tpu_torch.rl.fused`); with
``pallas_learner=True`` the learner is the ``kernel_prep`` path (K1b emits
the learner's rows, the GAE kernel K2, the grad-step kernel K3), and
episodes persist across iterations.  The JAX script's ``on_tpu`` /
``interpret`` switch has no counterpart: the port runs its kernels on the
card, their plain versions on the CPU.  The dense neg-risk reward is the
robust training objective.  Run with ``python -m
simglucose_tpu_torch.examples.train_ppo_fused``.
"""
B = 8192  # patients on one card
BLOCKS, ITERS_PER_BLOCK = 6, 100  # 600 iterations, one loop call per block
HIDDEN = 64


def main(batch: int = B, blocks: int = BLOCKS, iters_per_block: int = ITERS_PER_BLOCK,
         rollout_steps: int = 64, hidden: int = HIDDEN, device="cuda") -> list:
    """Returns each block's last metrics as floats."""
    import torch

    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import pack_params
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import PPOConfig, make_optimizer

    patient = tables.load_patient_params(tables.cohort_names(batch), device=device)
    packed = pack_params(patient, basal_rate(patient))
    cfg = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4, ent_coef=0.01,
                    lr=1e-3, pallas_learner=True)
    policy = init_policy(torch.Generator().manual_seed(1), hidden=hidden, act="relu",  # the kernel trunk
                         init_log_std=cfg.init_log_std, init_mu_bias=-2.2,  # safe cold start
                         device=device)
    ts = init_fused_state(policy, make_optimizer(cfg).init(policy), batch,
                          torch.Generator().manual_seed(0))
    loop = make_fused_train_loop(cfg, batch, iters_per_block, hidden=hidden,
                                 reward_kind="neg_risk")
    history = []
    for blk in range(blocks):
        ts, m = loop(packed, ts)
        last = {k: float(v[-1]) for k, v in m.items()}
        history.append(last)
        i = (blk + 1) * iters_per_block
        print(f"iter {i:4d}  reward {last['reward_mean']:+.4f}  "
              f"done/step {last['done_frac']:.4f}  "
              f"entropy {last['entropy']:.3f}")
    return history


if __name__ == "__main__":
    main()
