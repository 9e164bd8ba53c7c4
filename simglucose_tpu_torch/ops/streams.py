"""Counter-based random streams of the eager env path.

The JAX package keys its env path with threefry (``fold_in`` per lattice
point, per day and per reset).  The port draws from its own Philox-4x32-10
(:mod:`simglucose_tpu_torch.ops.philox`) instead; the streams agree with the
JAX package by law, not by bit.

An env's key is an int64 tensor ``[..., 4]``: the Philox key words (the
scenario seed and the CGM seed) and the first two counter words, the
patient's lane and its episode.  A draw adds the last two counter words: the
draw site and an index within it (the lattice point, the meal plan, the
reset candidate).  So a stream depends on (seeds, lane, episode, site,
index) and on nothing else: not on the batch it runs in, not on when the
draw is made, and never on a mixing of the two seeds into one number.

Every draw stays on the tensors' device: no host round trip, so the draws
run inside a time loop on the card without a synchronization.
"""
from __future__ import annotations

import math

import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.ops.philox import philox4x32

SITE_CGM = 0  # the AR(1) normal of one noise lattice point; index = lattice index
SITE_MEAL = 1  # 1..5: one daily meal plan's 18 uniforms; index = plan index
SITE_INIT_BG = 6  # the 3 normals of a random initial state; index 0, 1
SITE_RESET = 7  # an auto-reset candidate's episode word and start hour; index = salt
SITE_START = 8  # batch_reset's random start hour; index 0
SITE_ACTION = 9  # a policy's Gaussian action noise under a trainer's key; index = step
N_MEAL_SITES = 5


def env_keys(seed, batch: int, device="cuda") -> torch.Tensor:
    """``[batch, 4]`` keys of a batch of envs: the seed pair ``(scenario
    seed, cgm seed)`` (an int is ``(seed, 0)``), lanes ``0..batch-1``,
    episode 0."""
    device = check_device(device)
    k0, k1 = (seed, 0) if isinstance(seed, int) else seed
    key = torch.zeros(batch, 4, dtype=torch.int64, device=device)
    key[:, 0] = int(k0) & 0xFFFFFFFF
    key[:, 1] = int(k1) & 0xFFFFFFFF
    key[:, 2] = torch.arange(batch, device=device)
    return key


def draw(key: torch.Tensor, site, index) -> tuple:
    """Four int64 tensors of 32-bit words at counter (lane, episode, site,
    index) under the key's seed words.  ``site`` and ``index`` are ints or
    tensors broadcast against ``key[..., 0]``."""
    return philox4x32(key[..., 2], key[..., 3], site, index, key[..., 0], key[..., 1])


def uniforms(words, dtype) -> torch.Tensor:
    """32-bit words -> U(0, 1) in ``dtype``: the top 24 bits times 2**-24,
    clamped below at 1e-7 so that a logarithm or an inverse CDF of it stays
    finite."""
    return torch.clamp((words >> 8).to(dtype) * (2.0 ** -24), min=1e-7)


def _box_muller(words, dtype):
    """Two N(0, 1) from the first two words of a draw."""
    r = torch.sqrt(-2.0 * torch.log(uniforms(words[0], dtype)))
    th = (2.0 * math.pi) * uniforms(words[1], dtype)
    return r * torch.cos(th), r * torch.sin(th)


def normal(key: torch.Tensor, site, index, dtype) -> torch.Tensor:
    """One N(0, 1) per env, from the draw at ``(site, index)``."""
    return _box_muller(draw(key, site, index), dtype)[0]


def normals(key: torch.Tensor, site, n: int, dtype) -> torch.Tensor:
    """``[..., n]`` N(0, 1) per env: Box-Muller pairs from the draws at
    indices 0, 1, ... of ``site``."""
    out = []
    for j in range((n + 1) // 2):
        out += _box_muller(draw(key, site, j), dtype)
    return torch.stack(out[:n], dim=-1)


def meal_uniforms(key: torch.Tensor, index, dtype) -> torch.Tensor:
    """``[..., 18]`` uniforms of one daily meal plan: the words of sites
    ``SITE_MEAL .. SITE_MEAL + 4`` at ``index``, drawn in one call."""
    sites = torch.arange(SITE_MEAL, SITE_MEAL + N_MEAL_SITES, device=key.device)
    idx = index[..., None] if isinstance(index, torch.Tensor) else index
    words = torch.stack(draw(key[..., None, :], sites, idx), dim=-1).flatten(-2)  # [..., 20]
    return uniforms(words[..., :18], dtype)


def hour_of(words: torch.Tensor) -> torch.Tensor:
    """A uniform start hour in 0..23 (int32) from 32-bit words, by
    multiply-shift."""
    return ((words * 24) >> 32).to(torch.int32)


def action_normal(key: torch.Tensor, step, dtype) -> torch.Tensor:
    """The policy's action noise: one N(0, 1) per env at ``(lane, episode
    word of the key, SITE_ACTION, step)``.  The trainer's keys carry its
    seed pair and the lanes (:func:`env_keys`), so a stream is counted by
    (lane, step) as the rollout kernel's 'nn' controller counts its own."""
    return normal(key, SITE_ACTION, step, dtype)
