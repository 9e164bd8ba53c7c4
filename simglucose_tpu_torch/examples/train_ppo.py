"""PPO training over a patient cohort on the eager env path.

Counterpart of ``examples/train_ppo.py``: the analog of the reference's
rllab DDPG example (reference examples/run_rllab.py), as a single-program
actor-learner (:func:`~simglucose_tpu_torch.rl.ppo.make_train_step`).
Started as several ranks (``torchrun --nproc-per-node=N``), it trains
data-parallel, one rank per device, as the JAX script shards over every
device.  Run with ``python -m simglucose_tpu_torch.examples.train_ppo``.
"""
B = 256  # patients (sharded over the ranks of a multi-rank launch)
ITERS = 20


def main(batch: int = B, iters: int = ITERS, rollout_steps: int = 64, device="cuda") -> list:
    """Returns each iteration's metrics as floats."""
    import torch

    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.envs.build import cohort_names, make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.parallel.multihost import process_count, process_group
    from simglucose_tpu_torch.parallel.sharding import make_mesh, replicate, shard_batch
    from simglucose_tpu_torch.rl.policy import init_policy
    from simglucose_tpu_torch.rl.ppo import PPOConfig, TrainState, make_optimizer, make_train_step

    # joins the group of a torchrun launch and leaves it with the other
    # ranks; without torchrun's environment it does nothing
    with process_group():
        mesh = make_mesh() if process_count() > 1 else None
        if mesh is not None and device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        device = check_device(device)
        cfg, env_params = make_env(cohort_names(batch), batch=True, random_init_bg=True,
                                   device=device)
        env_state, reset_res = batch_reset(cfg, env_params, env_keys(0, batch, device=device))
        ppo_cfg = PPOConfig(rollout_steps=rollout_steps, epochs=2, minibatches=4)
        policy = init_policy(torch.Generator().manual_seed(1), init_log_std=ppo_cfg.init_log_std,
                             device=device)
        opt_state = make_optimizer(ppo_cfg).init(policy)
        key = env_keys((0, 1), batch, device=device)
        generator = torch.Generator().manual_seed(2)
        if mesh is not None:
            env_params, env_state, reset_res, key = (shard_batch(x, mesh) for x in
                                                     (env_params, env_state, reset_res, key))
            policy, opt_state, generator = (replicate(x, mesh) for x in
                                            (policy, opt_state, generator))
        ts = TrainState(params=policy, opt_state=opt_state, env_state=env_state, prev_res=reset_res,
                        key=key, generator=generator)
        train_step = make_train_step(ppo_cfg, cfg, mesh=mesh)

        history = []
        for it in range(iters):
            ts, metrics = train_step(env_params, ts)
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            print(f"iter {it:3d}  reward={m['reward_mean']:+.4f}  "
                  f"done%={100 * m['done_frac']:.2f}  "
                  f"pg={m['pg_loss']:+.4f}  "
                  f"v={m['v_loss']:.4f}")
        return history


if __name__ == "__main__":
    main()
