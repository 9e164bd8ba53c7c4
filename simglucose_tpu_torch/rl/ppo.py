"""PPO: the config, the optimizer, GAE, the loss and the learner over the
rollout kernel's learner rows.

Counterpart of ``simglucose_tpu/rl/ppo.py`` for the fused trainer's
learners: ``_update_packed`` over the rollout kernel's learner rows (the
``kernel_prep`` path) and ``_update`` over a [T, B] transition (the
observation-plane path), with its three learners.  The optimizer is optax's
``flatten(chain(clip_by_global_norm, adam))`` written out over one flat
parameter vector in ``ravel_pytree`` order, so an optax state converts
(:func:`opt_state_from_optax`) and one step gives optax's numbers:

* the clip scales by ``max_norm / |g|`` only when ``|g| >= max_norm``, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6: not used);
* Adam adds ``eps`` to ``sqrt(nu_hat)`` (``eps_root = 0``), and its bias
  corrections come from the step count, computed in double on the host and
  rounded to float32 once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.rl.policy import (
    LEAVES,
    OBS_DIM,
    PolicyParams,
    gaussian_logprob,
    policy_apply,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX PPOConfig, field for field (see its comments)."""

    rollout_steps: int = 64
    epochs: int = 2
    minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    max_basal: float = 30.0
    shuffle_block: int = 512
    reset_cadence: int = 1
    action_scale: float = 0.2
    scale_by_basal: bool = False
    decoder: str = "sigmoid"
    init_log_std: float = -0.5
    learner_bf16: bool = False
    pallas_learner: Union[bool, str] = False
    done_penalty: float = 0.0


class Transition(NamedTuple):
    obs: torch.Tensor
    raw_action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


# ---------------------------------------------------------------------------
# Flat parameters and the optimizer
# ---------------------------------------------------------------------------


def flatten_params(params: PolicyParams) -> torch.Tensor:
    """The nine leaves raveled and concatenated in field order
    (``jax.flatten_util.ravel_pytree``'s layout): a ``[P]`` vector."""
    return torch.cat([x.reshape(-1) for x in params.leaves()])


def unflatten_params(flat: torch.Tensor, like: PolicyParams) -> PolicyParams:
    """:func:`flatten_params` inverted: views of ``flat`` in ``like``'s
    leaf shapes, with ``like``'s metadata."""
    parts = torch.split(flat, [x.numel() for x in like.leaves()])
    return like.replace(**{n: p.view(x.shape) for n, p, x in zip(LEAVES, parts, like.leaves())})


class AdamState(NamedTuple):
    count: int  # steps taken (optax's ScaleByAdamState.count)
    mu: torch.Tensor  # [P]
    nu: torch.Tensor  # [P]


class FlatAdam:
    """``clip_by_global_norm(max_grad_norm)`` then Adam(lr), optax's
    formulas, on the flat parameter vector."""

    def __init__(self, lr: float, max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: PolicyParams) -> AdamState:
        flat = flatten_params(params)
        return AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat))

    def update(self, grads: torch.Tensor, state: AdamState):
        """(updates, new state) for the flat gradient ``grads``; add the
        updates to the flat parameters."""
        g_norm = torch.sqrt(torch.sum(grads * grads))
        grads = torch.where(g_norm < self.max_grad_norm, grads,
                            (grads / g_norm) * self.max_grad_norm)
        mu = (1 - self.b1) * grads + self.b1 * state.mu
        nu = (1 - self.b2) * (grads * grads) + self.b2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1.0 - self.b1 ** count)
        nu_hat = nu / (1.0 - self.b2 ** count)
        updates = (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * (-self.lr)
        return updates, AdamState(count, mu, nu)


def make_optimizer(cfg: PPOConfig) -> FlatAdam:
    return FlatAdam(cfg.lr, cfg.max_grad_norm)


def opt_state_from_optax(opt_state, device="cuda") -> AdamState:
    """The port's optimizer state from the JAX package's
    ``make_optimizer(cfg)`` state (optax.flatten of clip + adam): its one
    ScaleByAdamState's ``count`` and ``[P]`` ``mu``/``nu``, found by their
    field names (optax itself is not imported)."""
    found = []

    def rec(s):
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                rec(x)

    rec(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu); found {len(found)}")
    adam = found[0]
    device = check_device(device)
    as_t = lambda x: torch.as_tensor(np.array(x), dtype=torch.float32).to(device)
    return AdamState(int(np.asarray(adam.count)), as_t(adam.mu), as_t(adam.nu))


# ---------------------------------------------------------------------------
# GAE and the loss (the algorithm-level plain versions)
# ---------------------------------------------------------------------------


def _gae(cfg: PPOConfig, traj: Transition, last_value: torch.Tensor):
    """Generalized advantage estimation over a [T, B] rollout: the
    sequential reverse recurrence (the JAX package's associative scan
    reassociates the same sums)."""
    nonterm = 1.0 - traj.done.to(traj.value.dtype)
    T = traj.value.shape[0]
    advs = torch.empty_like(traj.value)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(T - 1, -1, -1):
        delta = traj.reward[t] + cfg.gamma * v_next * nonterm[t] - traj.value[t]
        adv_next = delta + cfg.gamma * cfg.lam * nonterm[t] * adv_next
        advs[t] = adv_next
        v_next = traj.value[t]
    return advs, advs + traj.value


def _ppo_loss(cfg: PPOConfig, params: PolicyParams, batch):
    """Clipped surrogate + vf_coef * value loss - ent_coef * entropy, the
    JAX ``_ppo_loss`` (advantages normalised with the population std)."""
    obs, raw, logp_old, adv, ret = batch
    mu, log_std, value = policy_apply(params, obs)
    logp = gaussian_logprob(mu, log_std, raw)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_loss = 0.5 * ((value - ret) ** 2).mean()
    entropy = log_std + 0.5 * math.log(2 * math.pi * math.e)
    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss, (pg_loss, v_loss, entropy)


def _gradout_to_grads(cfg: PPOConfig, params: PolicyParams, out, mb_size: int):
    """PPOGradOut (the grad-step kernel's sums) -> (flat gradient with the
    entropy term folded into log_std, aux loss triple)."""
    ent_const = 0.5 * math.log(2 * math.pi * math.e)
    grads = torch.cat([
        out.dw1.reshape(-1), out.db1, out.dw2.reshape(-1), out.db2,
        out.dw_head[:, 0], out.db_head[0:1], (out.dlog_std - cfg.ent_coef).reshape(1),
        out.dw_head[:, 1], out.db_head[1:2],
    ])
    aux = (out.pg_sum / mb_size, out.v_sum / mb_size, params.log_std[0] + ent_const)
    return grads, aux


def _shuffle_blocking(cfg: PPOConfig, N: int):
    """(block_rows, n_blocks, mb_size): the block-granular shuffle layout
    for an N-row buffer (see the JAX PPOConfig.shuffle_block)."""
    mb_size = N // cfg.minibatches
    bs = max(1, min(cfg.shuffle_block, N // 256))
    while mb_size % bs:
        bs //= 2
    return bs, N // bs, mb_size


def minibatch_adv_stats(adv_bsum, adv_bsq, perm_mb, mb_size: int):
    """A minibatch's advantage (mean, std) from its shuffle blocks' sums and
    sums of squares: E[x^2] - mean^2 clamped at 0, the JAX learner's formula
    (not ``torch.std``).  ``perm_mb`` [bpm] gives 0-dim tensors; [n_mb,
    bpm] (one minibatch a row) gives [n_mb]."""
    mean = adv_bsum[perm_mb].sum(-1) / mb_size
    std = torch.sqrt(torch.clamp(adv_bsq[perm_mb].sum(-1) / mb_size - mean * mean, min=0.0))
    return mean, std


def _update_packed(
    cfg: PPOConfig,
    opt: FlatAdam,
    params: PolicyParams,
    opt_state: AdamState,
    main_fm: torch.Tensor,
    advret_fm: torch.Tensor,
    generator: torch.Generator = None,
    perms=None,
):
    """The PPO learner over the rollout kernel's learner rows ``main_fm``
    [10, N] and the GAE pack ``advret_fm`` [2, N]: ``epochs`` x
    ``minibatches`` grad steps (K3), each followed by the clip and Adam.

    Each epoch permutes the shuffle blocks: ``perms[e]`` when given (so a
    test can hand both packages the same minibatches), else a
    ``torch.randperm`` drawn from ``generator``.  Returns (params,
    opt_state, aux): aux is (pg_loss, v_loss, entropy), each ``[epochs,
    minibatches]``."""
    from simglucose_tpu_torch.ops.ppo_learner import ppo_grad_step_gather2

    dev = main_fm.device
    N = main_fm.shape[1]
    bs, n_blocks, mb_size = _shuffle_blocking(cfg, N)
    bpm = n_blocks // cfg.minibatches
    adv_b = advret_fm[0].reshape(n_blocks, bs)
    adv_bsum = adv_b.sum(dim=1)
    adv_bsq = (adv_b * adv_b).sum(dim=1)
    flat = flatten_params(params)
    aux = []
    for e in range(cfg.epochs):
        if perms is None:
            perm = torch.randperm(n_blocks, generator=generator)
        else:
            perm = torch.as_tensor(np.array(perms[e]), dtype=torch.int64)
        perm = perm.to(dev)
        for i in range(cfg.minibatches):
            perm_mb = perm[i * bpm:(i + 1) * bpm]
            mean, std = minibatch_adv_stats(adv_bsum, adv_bsq, perm_mb, mb_size)
            w_head = torch.cat([params.w_mu, params.w_v], dim=1)
            b_head = torch.cat([params.b_mu, params.b_v])
            out = ppo_grad_step_gather2(
                main_fm, advret_fm, perm_mb, bs, params.w1, params.b1, params.w2, params.b2,
                w_head, b_head, params.log_std[0], mean, std, act=params.act,
                clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
            )
            grads, step_aux = _gradout_to_grads(cfg, params, out, mb_size)
            updates, opt_state = opt.update(grads, opt_state)
            flat = flat + updates
            params = unflatten_params(flat, params)
            aux.append(torch.stack(step_aux))
    aux = torch.stack(aux).reshape(cfg.epochs, cfg.minibatches, 3)
    return params, opt_state, (aux[..., 0], aux[..., 1], aux[..., 2])


# ---------------------------------------------------------------------------
# The learner over a [T, B] transition (the observation-plane path)
# ---------------------------------------------------------------------------


def _epoch_perms(cfg: PPOConfig, n_blocks: int, generator, perms, device):
    """Each epoch's permutation of the shuffle blocks: ``perms[e]`` when
    given, else a ``torch.randperm`` drawn from ``generator``."""
    out = []
    for e in range(cfg.epochs):
        if perms is None:
            p = torch.randperm(n_blocks, generator=generator)
        else:
            p = torch.as_tensor(np.array(perms[e]), dtype=torch.int64)
        out.append(p.to(device))
    return out


def _grad_step_updates(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams,
                       opt_state: AdamState, packed_fm, perm_all, block_rows, adv_mean, adv_std,
                       mb_rows: int, grad_step):
    """The ``'step'`` learner over the 12-row buffer: for each minibatch k
    (blocks ``perm_all[k*bpm:(k+1)*bpm]``, advantage statistics
    ``adv_mean[k]``/``adv_std[k]``) one ``grad_step``
    (:func:`~simglucose_tpu_torch.ops.ppo_learner.ppo_grad_step_gather` or
    its plain version), the entropy term, the clip and Adam.  Returns
    (params, opt_state, aux ``[n_mb, 4]``: pg loss, value loss, entropy,
    gradient norm)."""
    n_mb = adv_mean.shape[0]
    bpm = perm_all.shape[0] // n_mb
    flat = flatten_params(params)
    aux = []
    for k in range(n_mb):
        out = grad_step(
            packed_fm, perm_all[k * bpm:(k + 1) * bpm], block_rows, params.w1, params.b1,
            params.w2, params.b2, torch.cat([params.w_mu, params.w_v], dim=1),
            torch.cat([params.b_mu, params.b_v]), params.log_std[0], adv_mean[k], adv_std[k],
            act=params.act, clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, loss_rows=mb_rows,
        )
        grads, (pg, v, ent) = _gradout_to_grads(cfg, params, out, mb_rows)
        g_norm = torch.sqrt(torch.sum(grads * grads))
        updates, opt_state = opt.update(grads, opt_state)
        flat = flat + updates
        params = unflatten_params(flat, params)
        aux.append(torch.stack([pg, v, ent, g_norm]))
    return params, opt_state, torch.stack(aux)


def _epoch_kernel_update(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams,
                         opt_state: AdamState, packed_fm, perm_all, adv_mean, adv_std,
                         n_blocks: int, block_rows: int, mb_size: int):
    """``pallas_learner='epoch'``: the whole learner in one launch (K5,
    :func:`~simglucose_tpu_torch.ops.ppo_learner.ppo_epoch_update`), on the
    flat parameters and Adam moments."""
    from simglucose_tpu_torch.ops.ppo_learner import ppo_epoch_update

    if n_blocks % cfg.minibatches:
        raise ValueError(
            f"pallas_learner='epoch' needs the shuffle-block count ({n_blocks}) divisible "
            f"by minibatches ({cfg.minibatches}) — use the 'step' mode or a batch where "
            "T*B/shuffle_block divides evenly"
        )
    return ppo_epoch_update(cfg, opt, params, opt_state, packed_fm, perm_all, block_rows,
                            adv_mean, adv_std, mb_rows=mb_size)


def _autograd_updates(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams,
                      opt_state: AdamState, packed, epoch_perms, n_blocks, block_rows,
                      mb_size):
    """``pallas_learner=False``: the row-major ``[N, 11]`` buffer shuffled
    by block each epoch, and per minibatch ``torch.autograd.grad`` of
    :func:`_ppo_loss` (the JAX package's ``jax.grad`` learner), then the
    clip and Adam."""
    width = packed.shape[1]
    flat = flatten_params(params)
    aux = []
    for perm in epoch_perms:
        shuffled = packed.reshape(n_blocks, block_rows, width)[perm].reshape(-1, width)
        for i in range(cfg.minibatches):
            rows = shuffled[i * mb_size:(i + 1) * mb_size]
            mb = (rows[:, :OBS_DIM], rows[:, OBS_DIM], rows[:, OBS_DIM + 1],
                  rows[:, OBS_DIM + 2], rows[:, OBS_DIM + 3])
            leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
            loss, step_aux = _ppo_loss(cfg, params.replace(**dict(zip(LEAVES, leaves))), mb)
            grads = torch.autograd.grad(loss, leaves)
            updates, opt_state = opt.update(torch.cat([g.reshape(-1) for g in grads]), opt_state)
            flat = flat + updates
            params = unflatten_params(flat, params)
            aux.append(torch.stack([x.detach() for x in step_aux]))
    return params, opt_state, torch.stack(aux)


def _update(
    cfg: PPOConfig,
    opt: FlatAdam,
    params: PolicyParams,
    opt_state: AdamState,
    traj: Transition,
    advs: torch.Tensor,
    rets: torch.Tensor,
    generator: torch.Generator = None,
    perms=None,
):
    """The PPO learner over a [T, B] rollout: ``epochs`` x ``minibatches``
    clipped-surrogate updates of block-shuffled minibatches, by
    ``cfg.pallas_learner``: True / 'step', one grad-step kernel (K4) per
    minibatch over the 12-row buffer; 'epoch', the whole learner in one
    kernel (K5); False, autograd of the loss.

    Each epoch permutes the shuffle blocks: ``perms[e]`` when given (so a
    test can hand both packages the same minibatches), else a
    ``torch.randperm`` drawn from ``generator``.  Returns (params,
    opt_state, aux): aux is (pg_loss, v_loss, entropy), each ``[epochs,
    minibatches]``."""
    T, B = traj.reward.shape
    N = T * B
    obs = traj.obs.reshape(N, OBS_DIM)
    bs, n_blocks, mb_size = _shuffle_blocking(cfg, N)
    epoch_perms = _epoch_perms(cfg, n_blocks, generator, perms, advs.device)
    if cfg.pallas_learner:
        from simglucose_tpu_torch.ops.ppo_learner import pack_minibatch_rows, ppo_grad_step_gather

        packed = pack_minibatch_rows(obs, traj.raw_action.reshape(N), traj.logp.reshape(N),
                                     advs.reshape(N), rets.reshape(N))
        adv_b = advs.reshape(n_blocks, bs)
        bpm = n_blocks // cfg.minibatches
        # the schedule of every minibatch's blocks, and their advantage
        # statistics from per-block sums
        perm_all = torch.cat([p[:cfg.minibatches * bpm] for p in epoch_perms])
        adv_mean, adv_std = minibatch_adv_stats(adv_b.sum(dim=1), (adv_b * adv_b).sum(dim=1),
                                                perm_all.view(-1, bpm), mb_size)
        if cfg.pallas_learner == "epoch":
            params, opt_state, aux = _epoch_kernel_update(
                cfg, opt, params, opt_state, packed, perm_all, adv_mean, adv_std, n_blocks, bs,
                mb_size)
        else:
            params, opt_state, aux = _grad_step_updates(
                cfg, opt, params, opt_state, packed, perm_all, bs, adv_mean, adv_std, mb_size,
                ppo_grad_step_gather)
    else:
        packed = torch.cat([obs, traj.raw_action.reshape(N, 1), traj.logp.reshape(N, 1),
                            advs.reshape(N, 1), rets.reshape(N, 1)], dim=1)
        params, opt_state, aux = _autograd_updates(cfg, opt, params, opt_state, packed,
                                                   epoch_perms, n_blocks, bs, mb_size)
    aux = aux.reshape(cfg.epochs, cfg.minibatches, -1)
    return params, opt_state, (aux[..., 0], aux[..., 1], aux[..., 2])
