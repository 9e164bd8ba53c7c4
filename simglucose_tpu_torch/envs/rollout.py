"""Rollouts over the eager env path: Python time loops of batch-native
env steps.

Counterpart of ``simglucose_tpu/envs/rollout.py:94-535``, where the JAX
package compiles ``jit(vmap(scan))``: here ``lax.scan`` is a Python loop
over time, ``vmap`` the batch axes every function already takes, and
``lax.cond`` / ``lax.switch`` / compute-both-and-select are ``torch.where``
over candidates computed for every lane.  Nothing in a loop iteration reads
a value back to the host.

* :func:`rollout` / :func:`rollout_batch`: a fixed-horizon closed-loop
  rollout of a (controller, env) pair.
* :func:`make_batch_rollout_fn`: the RL-style rollout with auto-reset, a
  terminated env swapped for a fresh episode by a masked select.
* :func:`make_batch_continue_fn`: continues episodes without reset
  (chunked rollouts).

A controller's state is per env (a leading batch axis) or shared
(:func:`broadcast_ctrl_state` tiles it), which replaces JAX's ``in_axes``.
Not ported: ``pregen_env`` / ``rollout(pregen=True)`` and
``reset_cadence`` (speed options of the XLA scan).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from simglucose_tpu_torch.analysis.risk import risk_diff_reward
from simglucose_tpu_torch.controllers.functional import ControllerFn
from simglucose_tpu_torch.core.types import EnvState, StepResult, tree_map
from simglucose_tpu_torch.envs.functional import EnvConfig, EnvParams, env_reset, env_step
from simglucose_tpu_torch.ops.streams import SITE_RESET, SITE_START, draw, hour_of


def stack_results(results: list) -> StepResult:
    """Per-step results -> one StepResult with a leading time axis."""
    return tree_map(lambda *xs: torch.stack(xs), *results)


def rollout(
    cfg: EnvConfig,
    params: EnvParams,
    key: torch.Tensor,
    ctrl_init: Any,
    ctrl_fn: ControllerFn,
    n_steps: int,
    start_min=0,
    init_state: Optional[torch.Tensor] = None,
    reward_fun=risk_diff_reward,
) -> Tuple[EnvState, StepResult, StepResult]:
    """Closed-loop rollout of ``n_steps`` env steps.

    Returns ``(final state, reset result, results)``, the results stacked
    time first (``[T, ...]``).  The controller acts on the previous step's
    result, as in the reference loop."""
    state, reset_res = env_reset(cfg, params, key, start_min=start_min, init_state=init_state)
    ctrl_state, prev = ctrl_init, reset_res
    results = []
    for _ in range(n_steps):
        ctrl_state, action = ctrl_fn(ctrl_state, prev)
        state, prev = env_step(cfg, params, state, action, reward_fun=reward_fun)
        results.append(prev)
    return state, reset_res, stack_results(results)


def rollout_batch(
    cfg: EnvConfig,
    params: EnvParams,
    keys: torch.Tensor,
    ctrl_init: Any,
    ctrl_fn: ControllerFn,
    n_steps: int,
    start_min=0,
    reward_fun=risk_diff_reward,
    ctrl_in_axes=None,
):
    """:func:`rollout` over a batch of ``keys.shape[0]`` envs whose params
    carry the batch axis; histories come back ``[B, T]``, as the JAX
    function's.  ``ctrl_in_axes=0``: ``ctrl_init`` is per env; None: it is
    shared and tiled (:func:`broadcast_ctrl_state`)."""
    B = keys.shape[0]
    if ctrl_in_axes is None:
        ctrl_init = broadcast_ctrl_state(ctrl_init, B)
    state, reset_res, traj = rollout(cfg, params, keys, ctrl_init, ctrl_fn, n_steps,
                                     start_min=start_min, reward_fun=reward_fun)
    return state, reset_res, tree_map(lambda a: a.transpose(0, 1), traj)


# ---------------------------------------------------------------------------
# Auto-reset (RL path)
# ---------------------------------------------------------------------------


def _where(mask: torch.Tensor):
    """A select of ``a`` where ``mask`` (the envs' batch shape), else ``b``,
    over leaves with trailing axes."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)

    return pick


def make_reset_candidates(cfg: EnvConfig, params: EnvParams, state: EnvState,
                          salt: Optional[int] = None):
    """A fresh-episode candidate for every env: ``(state, reset result)``.

    One draw at ``(lane, episode, SITE_RESET, salt or 0)`` gives the new
    episode's counter word and a uniform start hour, so the candidate of an
    episode is fixed until it ends, and ``salt`` gives further independent
    candidates.  (JAX folds the patient clock into its key instead.)"""
    w = draw(state.key, SITE_RESET, salt or 0)
    new_key = torch.cat([state.key[..., :3], w[0][..., None]], dim=-1)
    return env_reset(cfg, params, new_key, start_min=hour_of(w[1]) * 60)


def autoreset_step_with_candidate(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action,
    cand: EnvState,
    cand_res: StepResult,
    n_adopt: Optional[torch.Tensor] = None,
    reward_fun=risk_diff_reward,
):
    """An env step (the midnight redraw deferred, ``scenario_regen=False``)
    that adopts a pre-drawn candidate where the episode ends.

    With ``n_adopt=None`` ``cand`` is one candidate; with ``n_adopt`` (int32
    adoptions so far per env) the candidate leaves carry a leading axis
    ``[C, ...]`` and an env's k-th termination adopts candidate
    ``min(k, C-1)``; the updated count is returned last."""
    state, res = env_step(cfg, params, state, action, reward_fun=reward_fun, scenario_regen=False)
    if n_adopt is not None:
        C = cand.done.shape[0]
        idx = torch.clamp(n_adopt, max=C - 1).to(torch.int64)

        def choose(a):
            i = idx.reshape(idx.shape + (1,) * (a.ndim - 1 - idx.ndim))
            return torch.gather(a, 0, i.expand((1,) + a.shape[1:]))[0]

        cand, cand_res = tree_map(choose, cand), tree_map(choose, cand_res)
    pick = _where(res.done)
    reset_state = tree_map(pick, cand, state)
    carry_res = tree_map(pick, cand_res, res)
    if n_adopt is not None:
        return reset_state, res, carry_res, n_adopt + res.done.to(torch.int32)
    return reset_state, res, carry_res


def autoreset_step(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action,
    reward_fun=risk_diff_reward,
    horizon_steps: Optional[int] = None,
):
    """One env step with gym-style auto-reset: where the step terminates
    (or, with ``horizon_steps``, reaches the horizon) the env takes a fresh
    episode with a random start hour.

    Returns ``(state, res, carry_res)`` (and the truncation flags with
    ``horizon_steps``): ``res`` is the step's result (the terminal one where
    the episode ended), ``carry_res`` what the next policy call must see,
    the new episode's reset result where it ended.  The returned state
    already belongs to the new episode there."""
    state, res = env_step(cfg, params, state, action, reward_fun=reward_fun)
    if horizon_steps is None:
        need_reset = res.done
    else:
        trunc = state.episode_step >= horizon_steps
        need_reset = res.done | trunc
    fresh, fresh_res = make_reset_candidates(cfg, params, state)
    pick = _where(need_reset)
    reset_state = tree_map(pick, fresh, state)
    carry_res = tree_map(pick, fresh_res, res)
    if horizon_steps is None:
        return reset_state, res, carry_res
    return reset_state, res, carry_res, trunc


def make_batch_rollout_fn(cfg: EnvConfig, ctrl_fn: ControllerFn, n_steps: int,
                          reward_fun=risk_diff_reward):
    """The batched auto-reset rollout: ``run(params, state, ctrl_state,
    prev_res) -> (state, last, traj[T, ...])``.  ``ctrl_state`` is per env
    (:func:`broadcast_ctrl_state` for a shared one); ``last`` is what the
    next call's first policy step sees (the reset result where the last
    step terminated), ``traj`` the terminal results."""

    def run(params: EnvParams, state: EnvState, ctrl_state, prev_res: StepResult):
        results = []
        for _ in range(n_steps):
            ctrl_state, action = ctrl_fn(ctrl_state, prev_res)
            state, res, prev_res = autoreset_step(cfg, params, state, action, reward_fun=reward_fun)
            results.append(res)
        return state, prev_res, stack_results(results)

    return run


def make_batch_continue_fn(cfg: EnvConfig, ctrl_fn: ControllerFn, n_steps: int,
                           reward_fun=risk_diff_reward):
    """The batched continuation without auto-reset (the reference's loop
    keeps integrating past termination): ``run(params, state, ctrl_state,
    prev_res) -> (state, ctrl_state, last, traj[T, ...])``."""

    def run(params: EnvParams, state: EnvState, ctrl_state, prev_res: StepResult):
        results = []
        for _ in range(n_steps):
            ctrl_state, action = ctrl_fn(ctrl_state, prev_res)
            state, prev_res = env_step(cfg, params, state, action, reward_fun=reward_fun)
            results.append(prev_res)
        return state, ctrl_state, prev_res, stack_results(results)

    return run


def broadcast_ctrl_state(ctrl_init, batch: int):
    """Tile a shared controller state's tensors across ``batch`` envs (other
    leaves are shared as they are)."""
    return tree_map(lambda a: a.expand((batch,) + a.shape) if isinstance(a, torch.Tensor) else a,
                    ctrl_init)


def batch_reset(cfg: EnvConfig, params: EnvParams, keys: torch.Tensor, start_min=None):
    """:func:`env_reset` of a batch (``keys`` ``[B, 4]``, params with the
    batch axis); without ``start_min`` each env starts at a random hour,
    drawn at ``(lane, episode, SITE_START, 0)``."""
    if start_min is None:
        start_min = hour_of(draw(keys, SITE_START, 0)[0]) * 60
    return env_reset(cfg, params, keys, start_min=start_min)
