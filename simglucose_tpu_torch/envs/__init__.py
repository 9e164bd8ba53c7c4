"""Environment layer of the port: the functional env, rollout engines and
the Gym adapters (the JAX package's ``simglucose_tpu.envs`` exports)."""
from simglucose_tpu_torch.envs.build import cohort_names, make_env
from simglucose_tpu_torch.envs.functional import (
    EnvConfig,
    EnvParams,
    env_reset,
    env_step,
    rewards_from_cgm,
    wrap_reward_fn,
)
from simglucose_tpu_torch.envs.rllab_compat import Step, step_result_to_rllab
from simglucose_tpu_torch.envs.rollout import (
    autoreset_step,
    batch_reset,
    broadcast_ctrl_state,
    make_batch_rollout_fn,
    rollout,
    rollout_batch,
)

__all__ = [
    "EnvConfig",
    "EnvParams",
    "env_reset",
    "env_step",
    "rewards_from_cgm",
    "wrap_reward_fn",
    "make_env",
    "cohort_names",
    "rollout",
    "rollout_batch",
    "autoreset_step",
    "batch_reset",
    "broadcast_ctrl_state",
    "make_batch_rollout_fn",
    "Step",
    "step_result_to_rllab",
    "T1DSimGymEnv",
    "T1DSimVectorEnv",
    "register_envs",
]


def __getattr__(name):
    # the Gym adapters load on first use (they build on gymnasium where it
    # is installed; the card's machine has none)
    if name in ("T1DSimGymEnv", "T1DSimVectorEnv", "register_envs"):
        from simglucose_tpu_torch.envs import gym_env

        return getattr(gym_env, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
