"""Random-agent episode through the Gymnasium API.

Counterpart of ``examples/run_gym.py`` (capability parity: reference
examples/run_gym.py), on the port's id ``simglucose_tpu_torch/T1DSim-v0``.
Run with ``python -m simglucose_tpu_torch.examples.run_gym``; needs
gymnasium.
"""
ENV_ID = "simglucose_tpu_torch/T1DSim-v0"


def main(steps: int = 100, device="cuda"):
    """Returns the CGM observations seen."""
    import gymnasium

    from simglucose_tpu_torch.envs import register_envs

    register_envs()
    env = gymnasium.make(ENV_ID, patient_name="adolescent#002", seed=0, device=device)
    obs, info = env.reset()
    seen = []
    for t in range(steps):
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        seen.append(float(obs[0]))
        print(f"t={t} CGM={obs[0]:7.2f} reward={reward:+.4f} BG={info['bg']:.1f}")
        if terminated or truncated:
            print("Episode finished after {} timesteps".format(t + 1))
            obs, info = env.reset()
    return seen


if __name__ == "__main__":
    main()
