"""Reward windows of the closed-loop environment, in PyTorch.

Counterpart of ``simglucose_tpu/envs/functional.py:60-149``: the one-hour
reward window law and the replay of the per-step reward plane from a CGM
trajectory, which is how the simulation engine serves any window-based
``reward_fun`` after the kernel has run.
"""
from __future__ import annotations

import inspect
from typing import Callable

import torch


def reward_window_size(sample_time: int) -> int:
    """One hour of CGM samples (reference env.py:100), at least 2."""
    return max(60 // int(sample_time), 2)


def wrap_reward_fn(reward_fun: Callable, window_size: int) -> Callable:
    """Adapt a reference-style 1-argument reward over the BG-last-hour
    history to the native ``(window, window_len)`` signature.

    The reference passes ``CGM_hist[-window_size:]``, which is shorter than
    an hour at episode start; the wrapper hands each lane exactly its
    ``window_len`` most recent samples, as a 1-D tensor.  Native 2-argument
    functions (over a ``[..., W]`` window, time last) pass through."""
    try:
        n_params = len(inspect.signature(reward_fun).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 2:
        return reward_fun
    W = int(window_size)

    def wrapped(window: torch.Tensor, window_len) -> torch.Tensor:
        L = min(max(int(window_len), 1), W)
        return torch.stack(
            [
                torch.as_tensor(reward_fun(lane[W - L:]), dtype=window.dtype, device=window.device)
                for lane in window.reshape(-1, W)
            ]
        ).reshape(window.shape[:-1])

    return wrapped


def reward_history(window_size: int, cgm0: torch.Tensor):
    """The ring buffer at reset: ``([W-1, B] samples, 1 real)``, all zero
    but the reset history sample ``cgm0`` at the end."""
    W = int(window_size)
    pad = torch.zeros(W - 2, *cgm0.shape, dtype=cgm0.dtype, device=cgm0.device)
    return torch.cat([pad, cgm0[None]]), 1


def replay_rewards(reward_fun: Callable, window_size: int, history, cgm: torch.Tensor):
    """Rewards of the ``[T, B]`` CGM steps that follow ``history``.

    ``history`` is ``(samples [W-1, B], n_real)``: the ``W-1`` most recent
    samples before the first step, oldest first, of which the last
    ``n_real`` are real.  Step ``t``'s window is the last ``W`` samples
    once its CGM is appended, with ``min(n_real + t + 1, W)`` of them real.
    The reward function sees every full window in one call over a
    ``[T', B, W]`` stack (``unfold``); only the first steps, whose window
    is still filling, are called one by one.  Returns the ``[T, B]``
    rewards and the history that follows the last step, so a trajectory
    replayed in pieces gives the same rewards as in one piece."""
    rf = wrap_reward_fn(reward_fun, window_size)
    W = int(window_size)
    past, n_real = history
    seq = torch.cat([past, cgm])
    windows = seq.unfold(0, W, 1)  # [T, B, W], time last
    T = cgm.shape[0]
    out = torch.empty(cgm.shape, dtype=cgm.dtype, device=cgm.device)
    filling = min(max(W - 1 - n_real, 0), T)
    for t in range(filling):
        out[t] = torch.as_tensor(rf(windows[t], n_real + t + 1), dtype=cgm.dtype, device=cgm.device)
    if filling < T:
        out[filling:] = torch.as_tensor(rf(windows[filling:], W), dtype=cgm.dtype, device=cgm.device)
    return out, (seq[seq.shape[0] - (W - 1):], min(n_real + T, W - 1))


def rewards_from_cgm(
    reward_fun: Callable, window_size: int, cgm0: torch.Tensor, cgm: torch.Tensor
) -> torch.Tensor:
    """The ``[T, B]`` reward plane of a CGM trajectory, replaying the
    environment's ring-buffer window: the window starts as ``[cgm0]`` (the
    reset history sample, length 1) and each step appends that step's CGM,
    keeping the last ``window_size`` samples."""
    rewards, _ = replay_rewards(reward_fun, window_size, reward_history(window_size, cgm0), cgm)
    return rewards
