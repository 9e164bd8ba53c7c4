"""Custom reward function plumbed into the gym env.

Counterpart of ``examples/custom_reward_function.py`` (capability parity:
reference examples/custom_reward_function.py).  Run with ``python -m
simglucose_tpu_torch.examples.custom_reward_function``; gymnasium is not
needed (the env constructs, resets and steps without it).
"""
import numpy as np
import torch


def custom_reward(bg_hist):
    """Reference-style single-argument reward over the last-hour CGM
    window: +1 in range, -1 hyper, -2 hypo."""
    bg = bg_hist[-1]
    return torch.where(bg > 180, -1.0, torch.where(bg < 70, -2.0, 1.0))


def main(steps: int = 30, device="cuda"):
    """Returns the rewards of the steps taken."""
    from simglucose_tpu_torch.envs.gym_env import T1DSimGymEnv

    env = T1DSimGymEnv(patient_name="adolescent#002", reward_fun=custom_reward, seed=0,
                       device=device)
    obs, info = env.reset()
    rewards = []
    for t in range(steps):
        obs, reward, terminated, truncated, info = env.step(np.asarray([0.01]))
        rewards.append(reward)
        print(f"t={t} CGM={obs[0]:7.2f} reward={reward:+.1f}")
        if terminated:
            break
    return rewards


if __name__ == "__main__":
    main()
