"""PPO (Schulman et al., 2017) on the closed-loop rollout, written out
plainly: the rollout of :mod:`benchmark.reference.rollout` with the policy
inside (sampled actions), GAE (Schulman et al., 2016) by its backward
recurrence, then ``epochs`` x ``minibatches`` steps of the clipped
surrogate + value loss - entropy bonus, each differentiated by autograd,
clipped to a global norm and applied by Adam (optax's formulas: no
epsilon in the clip, ``eps`` added to sqrt(nu_hat)).

The rollout writes one learner row per lane and step at column ``t * B +
b``; the minibatches are ``shuffle_block``-row blocks of those columns,
each epoch's blocks in the order of a permutation the caller draws.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import rollout as ref

LEAVES = ("w1", "b1", "w2", "b2", "w_mu", "b_mu", "log_std", "w_v", "b_v")


def gae(reward, done, value, tail_value, gamma: float, lam: float) -> tuple:
    """Advantages and returns ``[T, B]``."""
    nonterm = 1.0 - done.to(value.dtype)
    adv = torch.empty_like(value)
    a_next, v_next = torch.zeros_like(tail_value), tail_value
    for t in range(value.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * v_next * nonterm[t] - value[t]
        a_next = delta + gamma * lam * nonterm[t] * a_next
        adv[t] = a_next
        v_next = value[t]
    return adv, adv + value


def minibatch_loss(conf: dict, policy: dict, rows: dict, mean, std) -> tuple:
    """(loss, pg, v, entropy) over a minibatch's rows (advantages
    normalised by the minibatch's ``mean`` and ``std``)."""
    mu, value = ref.mlp(policy, rows["obs"])
    log_std = policy["log_std"][0]
    z = (rows["raw"] - mu) * torch.exp(-log_std)
    logp = -0.5 * z * z - log_std - 0.5 * ref.LOG_2PI
    ratio = torch.exp(logp - rows["logp"])
    adv_n = (rows["adv"] - mean) / (std + 1e-8)
    eps = conf["clip_eps"]
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n).mean()
    v = (0.5 * (value - rows["ret"]) ** 2).mean()
    entropy = log_std + 0.5 * math.log(2 * math.pi * math.e)
    return pg + conf["vf_coef"] * v - conf["ent_coef"] * entropy, pg, v, entropy


def adam(conf: dict, flat, grads, state: dict) -> tuple:
    """Clip ``grads`` to the global norm, then one Adam step: (new flat
    params, new state)."""
    b1, b2 = 0.9, 0.999
    norm = torch.sqrt(torch.sum(grads * grads))
    mx = conf["max_grad_norm"]
    grads = torch.where(norm < mx, grads, (grads / norm) * mx)
    mu = (1 - b1) * grads + b1 * state["mu"]
    nu = (1 - b2) * (grads * grads) + b2 * state["nu"]
    count = state["count"] + 1
    step = (mu / (1.0 - b1 ** count)) / (torch.sqrt(nu / (1.0 - b2 ** count)) + 1e-8)
    return flat - conf["lr"] * step, {"count": count, "mu": mu, "nu": nu}


def flatten(policy: dict):
    return torch.cat([policy[k].reshape(-1) for k in LEAVES])


def unflatten(flat, like: dict) -> dict:
    parts = torch.split(flat, [like[k].numel() for k in LEAVES])
    return {k: p.view(like[k].shape) for k, p in zip(LEAVES, parts)}


def blocking(conf: dict, N: int) -> tuple:
    """(block rows, blocks, minibatch rows) of an ``N``-row buffer: blocks
    of ``shuffle_block`` rows at most (and at most N / 256), halved until a
    minibatch holds whole blocks."""
    mb = N // conf["minibatches"]
    bs = max(1, min(conf["shuffle_block"], N // 256))
    while mb % bs:
        bs //= 2
    return bs, N // bs, mb


def iteration(conf: dict, rcfg: ref.Config, pt: dict, lanes, policy: dict, opt: dict,
              sim_state, key, perms, fault: str = None) -> tuple:
    """One training iteration: the rollout under ``key`` (continuing
    ``sim_state``), GAE, and the learner over ``perms`` (one block
    permutation an epoch).  ``fault='half_batch'`` drops the second half of
    every minibatch's rows, the mean taken over the rest.  Returns
    (policy, opt, sim_state, metrics: pg_loss, v_loss, entropy as the
    means over the grad steps)."""
    out, sim_state = ref.rollout(rcfg, pt, key, lanes, state=sim_state, policy=policy,
                                 dtype=policy["w1"].dtype)
    T, B = out["BG"].shape
    done = out["done"].to(out["value"].dtype)
    adv, ret = gae(out["reward"], done, out["value"], out["tail_value"], conf["gamma"],
                   conf["lam"])
    cols = {"obs": out["obs"].reshape(T * B, 7), "raw": out["raw"].reshape(-1),
            "logp": out["logp"].reshape(-1), "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
    n_mb = conf["minibatches"]
    bs, n_blocks, mb = blocking(conf, T * B)
    bpm = n_blocks // n_mb
    block_sum = cols["adv"].reshape(-1, bs).sum(1)
    block_sq = (cols["adv"].reshape(-1, bs) ** 2).sum(1)
    flat = flatten(policy)
    aux = []
    for perm in perms:
        for i in range(n_mb):
            blocks = perm[i * bpm:(i + 1) * bpm].to(lanes.device)
            mean = block_sum[blocks].sum() / mb
            std = torch.sqrt(torch.clamp(block_sq[blocks].sum() / mb - mean * mean, min=0.0))
            idx = (blocks[:, None] * bs + torch.arange(bs, device=lanes.device)).reshape(-1)
            if fault == "half_batch":
                idx = idx[: idx.numel() // 2]
            rows = {k: v[idx] for k, v in cols.items()}
            leaves = {k: v.detach().requires_grad_(True) for k, v in policy.items()}
            loss, pg, v, ent = minibatch_loss(conf, leaves, rows, mean, std)
            grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES])
            flat, opt = adam(conf, flat, torch.cat([g.reshape(-1) for g in grads]), opt)
            policy = unflatten(flat, policy)
            aux.append(torch.stack([pg.detach(), v.detach(), ent.detach()]))
    aux = torch.stack(aux).mean(0)
    return policy, opt, sim_state, dict(zip(("pg_loss", "v_loss", "entropy"), aux))
