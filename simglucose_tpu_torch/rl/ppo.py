"""PPO: the config, the optimizer, GAE, the loss, the learners and the
XLA-path trainer.

Counterpart of ``simglucose_tpu/rl/ppo.py``: ``_update_packed`` over the
rollout kernel's learner rows (the fused trainer's ``kernel_prep`` path),
``_update`` over a [T, B] transition (the fused trainer's
observation-plane path and :func:`make_train_step`), with its three
learners, each also data-parallel over a mesh of ranks, and
:func:`make_train_step`, the trainer over the eager env
(:mod:`simglucose_tpu_torch.envs`): a rollout of sampled actions with
auto-reset, GAE and ``_update``.  ``PPOConfig.learner_bf16`` rounds the
learner's matmul operands to bfloat16 (float32 accumulation) wherever the
JAX package does: the autograd loss, and the grad-step kernels K3, K4 and
K5 through their ``compute_dtype``.  Under a mesh with ``tp > 1`` the
policy's hidden dimension is split over the ``tp`` ranks
(``rl/policy.py::policy_apply``) in the rollout, the bootstrap value and
the autograd learner, which every ``pallas_learner`` then runs, as in
JAX.  The optimizer is optax's
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
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.core.types import CtrlAction, EnvState, StepResult
from simglucose_tpu_torch.envs.functional import wrap_reward_fn
from simglucose_tpu_torch.envs.rollout import autoreset_step
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.parallel.sharding import all_reduce_sum, check_mesh, resolve_mesh
from simglucose_tpu_torch.rl.policy import (
    LEAVES,
    OBS_DIM,
    PolicyParams,
    check_action_decoder,
    featurize,
    gaussian_logprob,
    iob_step,
    pack_head,
    policy_apply,
    sample_action,
)
from simglucose_tpu_torch.utils.profiling import span


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


def learner_dtype(cfg: PPOConfig):
    """The learner's matmul operand dtype: bfloat16 with ``learner_bf16``."""
    return torch.bfloat16 if cfg.learner_bf16 else torch.float32


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
        """(updates, new state) for the flat gradient ``grads``: the clip,
        then Adam; add the updates to the flat parameters."""
        return self.adam(self.clip(grads)[0], state)

    def clip(self, grads: torch.Tensor):
        """(``grads`` clipped to the global norm ``max_grad_norm``, their
        norm before the clip)."""
        g_norm = torch.sqrt(torch.sum(grads * grads))
        return torch.where(g_norm < self.max_grad_norm, grads,
                           (grads / g_norm) * self.max_grad_norm), g_norm

    def adam(self, grads: torch.Tensor, state: AdamState):
        """(updates, new state): Adam's step on the clipped ``grads``."""
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


def _ppo_row_terms(cfg: PPOConfig, params: PolicyParams, batch, adv_mean, adv_std, mesh=None):
    """Each row's clipped-surrogate term ``-min(pg1, pg2)`` and value term
    ``0.5 (v - ret)^2`` (advantages normalised by ``adv_mean``/``adv_std``),
    and the entropy; the forward in bfloat16 with ``learner_bf16``, split
    over the ``tp`` ranks of ``mesh``."""
    obs, raw, logp_old, adv, ret = batch
    mu, log_std, value = policy_apply(params, obs, compute_dtype=learner_dtype(cfg), mesh=mesh)
    logp = gaussian_logprob(mu, log_std, raw)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    entropy = log_std + 0.5 * math.log(2 * math.pi * math.e)
    return -torch.minimum(pg1, pg2), 0.5 * (value - ret) ** 2, entropy


def _ppo_loss(cfg: PPOConfig, params: PolicyParams, batch):
    """Clipped surrogate + vf_coef * value loss - ent_coef * entropy, the
    JAX ``_ppo_loss`` (advantages normalised with the population std)."""
    adv = batch[3]
    pg, v, entropy = _ppo_row_terms(cfg, params, batch, adv.mean(), adv.std(correction=0))
    pg_loss, v_loss = pg.mean(), v.mean()
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


def minibatch_adv_stats(adv_bsum, adv_bsq, perm_mb, mb_size: int, mesh=None):
    """A minibatch's advantage (mean, std) from its shuffle blocks' sums and
    sums of squares: E[x^2] - mean^2 clamped at 0, the JAX learner's formula
    (not ``torch.std``).  ``perm_mb`` [bpm] gives 0-dim tensors; [n_mb,
    bpm] (one minibatch a row) gives [n_mb].  Under a ``mesh`` the blocks
    are each rank's own and ``mb_size`` the global minibatch: the sums go
    through one all-reduce over ``'dp'``."""
    sums = all_reduce_sum(torch.stack([adv_bsum[perm_mb].sum(-1), adv_bsq[perm_mb].sum(-1)]),
                          mesh, "dp")
    mean = sums[0] / mb_size
    std = torch.sqrt(torch.clamp(sums[1] / mb_size - mean * mean, min=0.0))
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
    ``minibatches`` grad steps (K3), each followed by the clip and Adam
    (:func:`_grad_step_updates`).

    Each epoch permutes the shuffle blocks: ``perms[e]`` when given (so a
    test can hand both packages the same minibatches), else a
    ``torch.randperm`` drawn from ``generator``.  Returns (params,
    opt_state, aux): aux is (pg_loss, v_loss, entropy), each ``[epochs,
    minibatches]``."""
    from simglucose_tpu_torch.ops import ppo_learner

    bs, n_blocks, mb_size = _shuffle_blocking(cfg, main_fm.shape[1])
    epoch_perms = _epoch_perms(cfg, n_blocks, generator, perms, main_fm.device)
    perm_all, adv_mean, adv_std = _schedule(cfg, epoch_perms, advret_fm[0], n_blocks, bs, mb_size)
    params, opt_state, aux = _grad_step_updates(
        cfg, opt, params, opt_state, perm_all, adv_mean, adv_std, mb_size,
        ppo_learner.ppo_grad_step_gather2, main_fm, advret_fm, block_rows=bs,
        compute_dtype=learner_dtype(cfg))
    aux = aux.reshape(cfg.epochs, cfg.minibatches, -1)
    return params, opt_state, (aux[..., 0], aux[..., 1], aux[..., 2])


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


def _schedule(cfg: PPOConfig, epoch_perms, adv, n_blocks: int, block_rows: int, mb_rows: int,
              mesh=None):
    """(perm_all, adv_mean, adv_std): every minibatch's shuffle blocks in
    turn (``bpm`` of each epoch's permutation a minibatch) and, from one
    :func:`minibatch_adv_stats` over the per-block sums of ``adv`` [N],
    every minibatch's advantage statistics ``[n_mb]``."""
    bpm = n_blocks // cfg.minibatches
    perm_all = torch.cat([p[:cfg.minibatches * bpm] for p in epoch_perms])
    adv_b = adv.reshape(n_blocks, block_rows)
    adv_mean, adv_std = minibatch_adv_stats(adv_b.sum(dim=1), (adv_b * adv_b).sum(dim=1),
                                            perm_all.view(-1, bpm), mb_rows, mesh)
    return perm_all, adv_mean, adv_std


def _grad_step_updates(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams,
                       opt_state: AdamState, perm_all, adv_mean, adv_std, mb_rows: int,
                       grad_step, *buffers, block_rows: int, compute_dtype=torch.float32, **kw):
    """The grad-step learners' loop: K3 over the rollout's rows
    (:func:`_update_packed`), K4 over the 12-row buffer
    (:func:`_kernel_updates`) and K5's plain version.  For each minibatch k
    (shuffle blocks ``perm_all[k*bpm:(k+1)*bpm]``, advantage statistics
    ``adv_mean[k]``/``adv_std[k]``) one ``grad_step`` (the kernel, or its
    plain version, called on its ``buffers``, ``block_rows``,
    ``compute_dtype`` and ``kw``), the entropy term, the clip and Adam.
    Returns (params, opt_state, aux ``[n_mb, 4]``: pg loss, value loss,
    entropy, gradient norm before the clip)."""
    n_mb = adv_mean.shape[0]
    bpm = perm_all.shape[0] // n_mb
    flat = flatten_params(params)
    aux = []
    for k in range(n_mb):
        with span("learner.minibatch"):
            w_head, b_head = pack_head(params)
            out = grad_step(
                *buffers, perm_all[k * bpm:(k + 1) * bpm], block_rows, params.w1, params.b1,
                params.w2, params.b2, w_head, b_head, params.log_std[0], adv_mean[k], adv_std[k],
                act=params.act, clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
                compute_dtype=compute_dtype, **kw)
            with span("learner.adam"):
                grads, (pg, v, ent) = _gradout_to_grads(cfg, params, out, mb_rows)
                grads, g_norm = opt.clip(grads)
                updates, opt_state = opt.adam(grads, opt_state)
                flat = flat + updates
                params = unflatten_params(flat, params)
            aux.append(torch.stack([pg, v, ent, g_norm]))
    return params, opt_state, torch.stack(aux)


# ---------------------------------------------------------------------------
# The learner over a [T, B] transition (the observation-plane path)
# ---------------------------------------------------------------------------


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
                            adv_mean, adv_std, mb_rows=mb_size, compute_dtype=learner_dtype(cfg))


def _autograd_updates(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams,
                      opt_state: AdamState, packed, epoch_perms, block_rows, mb_size,
                      batch: int, mesh):
    """``pallas_learner=False`` (and 'epoch' under a live mesh, and every
    learner under ``tp > 1``): the shuffle blocks of the global ``batch``'s
    rows permuted each epoch, and per minibatch ``torch.autograd.grad`` of
    the loss (the JAX package's ``jax.grad`` learner; under a mesh, what its
    XLA learner computes under GSPMD), then the clip and Adam.

    ``packed`` is the row-major ``[N, 11]`` buffer of the rows this rank
    holds: row ``t*Bl + j`` is global row ``t*batch + dp_rank*Bl + j``
    (GAE's layout, ``Bl`` the lanes of a ``dp`` coordinate; on one rank
    every row).  ``epoch_perms`` permute the global shuffle blocks and
    ``mb_size`` is the global minibatch.  Per minibatch each rank takes the
    shuffled rows its ``dp`` coordinate holds (no row moves): two
    all-reduces over ``'dp'`` give the advantage mean and std.  Autograd of
    ``sum(row terms) / mb_size`` gives each leaf's gradient over those rows,
    already summed over ``'tp'`` where the policy is split
    (``policy_apply``), and one all-reduce over ``'dp'`` sums it with the
    loss sums; the entropy's gradient is added once, after it.  Every
    reduction is the identity on a mesh of one rank."""
    Bl = batch // mesh.dp
    dev = packed.device
    n_rows = cfg.minibatches * mb_size
    ent_slot = sum(x.numel() for x in params.leaves()[:LEAVES.index("log_std")])
    flat = flatten_params(params)
    aux = []
    for perm in epoch_perms:
        g = perm[:, None] * block_rows + torch.arange(block_rows, device=dev)
        g = g.reshape(-1)[:n_rows]  # global rows in the shuffled order
        if mesh.dp == 1:
            local, counts = g, [mb_size] * cfg.minibatches
        else:  # a shuffle block may straddle two ranks: own by row
            lane = g % batch
            mine = lane // Bl == mesh.dp_rank
            local = ((g // batch) * Bl + lane - mesh.dp_rank * Bl)[mine]
            counts = mine.view(cfg.minibatches, mb_size).sum(dim=1).tolist()
        for idx in torch.split(local, counts):
            rows = packed[idx]
            mb = (rows[:, :OBS_DIM], rows[:, OBS_DIM], rows[:, OBS_DIM + 1],
                  rows[:, OBS_DIM + 2], rows[:, OBS_DIM + 3])
            adv = mb[3]
            mean = all_reduce_sum(adv.sum(), mesh, "dp") / mb_size
            std = torch.sqrt(all_reduce_sum(((adv - mean) ** 2).sum(), mesh, "dp") / mb_size)
            leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
            pg, v, entropy = _ppo_row_terms(cfg, params.replace(**dict(zip(LEAVES, leaves))), mb,
                                            mean, std, mesh)
            pg_sum, v_sum = pg.sum(), v.sum()
            grads = torch.autograd.grad((pg_sum + cfg.vf_coef * v_sum) / mb_size, leaves)
            red = all_reduce_sum(torch.cat([x.reshape(-1) for x in grads]
                                           + [pg_sum.detach()[None], v_sum.detach()[None]]),
                                 mesh, "dp")
            grads = red[:-2]
            grads[ent_slot] -= cfg.ent_coef
            updates, opt_state = opt.update(grads, opt_state)
            flat = flat + updates
            params = unflatten_params(flat, params)
            aux.append(torch.stack([red[-2] / mb_size, red[-1] / mb_size, entropy.detach()]))
    return params, opt_state, torch.stack(aux)


def _kernel_updates(cfg: PPOConfig, opt: FlatAdam, params: PolicyParams, opt_state: AdamState,
                    traj: Transition, advs, rets, epoch_perms, bs, n_blocks, mb_size, mesh):
    """``pallas_learner`` True / 'step' (K4 per minibatch) or 'epoch' (K5,
    on one process only) over the 12-row buffer of ``traj``'s rows, on a
    mesh with ``tp == 1``.  The rows and blocks are this rank's and
    ``mb_size`` the rank's share of a minibatch: the advantage statistics
    and each grad step's sums go through an all-reduce over ``'dp'`` (the
    identity without a group), the losses scaled by the global
    minibatch."""
    from simglucose_tpu_torch.ops.ppo_learner import pack_minibatch_rows, ppo_grad_step_gather

    N = traj.reward.numel()
    packed = pack_minibatch_rows(traj.obs.reshape(N, OBS_DIM), traj.raw_action.reshape(N),
                                 traj.logp.reshape(N), advs.reshape(N), rets.reshape(N))
    mb_rows = mb_size * mesh.dp
    perm_all, adv_mean, adv_std = _schedule(cfg, epoch_perms, advs, n_blocks, bs, mb_rows, mesh)
    if cfg.pallas_learner == "epoch":
        return _epoch_kernel_update(cfg, opt, params, opt_state, packed, perm_all, adv_mean,
                                    adv_std, n_blocks, bs, mb_size)

    def grad_step(*args, **kwargs):
        out = ppo_grad_step_gather(*args, **kwargs)
        if not mesh.live:
            return out
        red = all_reduce_sum(torch.cat([x.reshape(-1) for x in out]), mesh, "dp")
        return type(out)(*(r.view(x.shape) for r, x in
                           zip(torch.split(red, [x.numel() for x in out]), out)))

    return _grad_step_updates(cfg, opt, params, opt_state, perm_all, adv_mean, adv_std, mb_rows,
                              grad_step, packed, block_rows=bs, compute_dtype=learner_dtype(cfg),
                              loss_rows=mb_rows)


def _row_major(traj: Transition, advs, rets):
    """The autograd learner's ``[N, 11]`` rows: features, raw action,
    log-prob, advantage, return."""
    N = traj.reward.numel()
    return torch.cat([traj.obs.reshape(N, OBS_DIM), traj.raw_action.reshape(N, 1),
                      traj.logp.reshape(N, 1), advs.reshape(N, 1), rets.reshape(N, 1)], dim=1)


def global_means(tensors, mesh) -> list:
    """Each tensor's mean over the whole batch when the ``dp`` coordinates
    of ``mesh`` hold equal shares of it (one all-reduce over ``'dp'`` of
    the local means over ``dp``; on one rank the local means, bit for
    bit)."""
    if mesh is None:
        return [t.mean() for t in tensors]
    return list(all_reduce_sum(torch.stack([t.mean() / mesh.dp for t in tensors]), mesh, "dp"))


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
    mesh=None,
):
    """The PPO learner over a [T, B] rollout: ``epochs`` x ``minibatches``
    clipped-surrogate updates of block-shuffled minibatches, by
    ``cfg.pallas_learner``: True / 'step', one grad-step kernel (K4) per
    minibatch over the 12-row buffer; 'epoch', the whole learner in one
    kernel (K5); False, autograd of the loss.  Each computes in bfloat16
    with ``cfg.learner_bf16``.

    Each epoch permutes the shuffle blocks: ``perms[e]`` when given (so a
    test can hand both packages the same minibatches), else a
    ``torch.randperm`` drawn from ``generator``.  Returns (params,
    opt_state, aux): aux is (pg_loss, v_loss, entropy), each ``[epochs,
    minibatches]``.

    With a ``mesh`` (:mod:`simglucose_tpu_torch.parallel.sharding`) it is
    the counterpart of the JAX ``_update_pallas_dp`` and of its XLA
    learner under a mesh: ``traj`` holds this rank's lanes ([T, B/n]); the
    policy, the optimizer state and ``generator`` are replicated, so every
    rank draws the same permutations and applies the same update and the
    ranks' params stay bit-identical.

    * True / 'step': K4 per rank over its own 12-row buffer.  Each epoch
      permutes the rank's own shuffle blocks (the same indices on every
      rank, JAX's law: a minibatch is the union of the ranks' block
      draws), one all-reduce gives every minibatch's global advantage
      statistics, and one per minibatch the gradient and loss sums, scaled
      by the global minibatch.
    * False and 'epoch': the autograd learner on the global batch
      (:func:`_autograd_updates`), as JAX runs its XLA learner under a
      mesh (``use_pallas = ... and mesh is None``).
    * Under ``tp > 1`` every ``pallas_learner`` value runs the autograd
      learner with the policy split over ``'tp'`` (JAX's kernel learner
      takes dp-only meshes); ``traj`` holds the lanes of this rank's
      ``dp`` coordinate."""
    on_kernel = (cfg.pallas_learner in (True, "step") or (cfg.pallas_learner == "epoch"
                                                          and mesh is None)) \
        and (mesh is None or mesh.tp == 1)
    mesh = resolve_mesh(mesh, allow_tp=True)
    T, Bl = traj.reward.shape
    B = Bl if on_kernel else Bl * mesh.dp  # the batch the shuffle blocks tile
    bs, n_blocks, mb_size = _shuffle_blocking(cfg, T * B)
    epoch_perms = _epoch_perms(cfg, n_blocks, generator, perms, advs.device)
    if on_kernel:
        params, opt_state, aux = _kernel_updates(cfg, opt, params, opt_state, traj, advs, rets,
                                                 epoch_perms, bs, n_blocks, mb_size, mesh)
    else:
        params, opt_state, aux = _autograd_updates(cfg, opt, params, opt_state,
                                                   _row_major(traj, advs, rets), epoch_perms, bs,
                                                   mb_size, B, mesh)
    aux = aux.reshape(cfg.epochs, cfg.minibatches, -1)
    return params, opt_state, (aux[..., 0], aux[..., 1], aux[..., 2])


# ---------------------------------------------------------------------------
# The XLA-path trainer: the eager env, sampled actions, GAE, _update
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """The JAX TrainState on the port's streams.  ``key`` holds the envs'
    ``[B, 4]`` action keys (``ops/streams.py::env_keys`` of the trainer's
    seed pair) and ``step`` the env steps taken so far: together they count
    the action noise by (lane, step).  ``generator`` (a CPU
    ``torch.Generator``) draws the shuffle permutations.  ``cgm_prev`` /
    ``iob``: the observation-memory carries behind the trend and
    insulin-on-board features; None is the cold start (zero trend, zero
    IOB, exactly the episode-reset observation)."""

    params: PolicyParams
    opt_state: AdamState
    env_state: EnvState
    prev_res: StepResult
    key: torch.Tensor
    generator: torch.Generator
    step: int = 0
    cgm_prev: Optional[torch.Tensor] = None
    iob: Optional[torch.Tensor] = None


def _rollout(cfg: PPOConfig, env_cfg, env_params, params: PolicyParams, env_state: EnvState,
             prev_res: StepResult, cgm_prev, iob, patient_basal, key, step: int,
             reward_fun=None, mesh=None):
    """Collect ``rollout_steps`` transitions from the batched auto-reset env
    (:func:`simglucose_tpu_torch.envs.rollout.autoreset_step`), each action
    sampled from the policy at global step ``step + t``.  ``cgm_prev`` /
    ``iob`` follow the auto-reset semantics of the rollout kernel's 'nn'
    controller: the trend baseline is the CGM just acted on and IOB adds
    the delivered dose; a reset zeroes both (the post-reset observation has
    no history).  ``mesh`` splits the policy (``sample_action``).  Returns
    (env_state, last result, cgm_prev, iob, Transition [T, B, ...]).
    Nothing reads a value back to the host."""
    step_kwargs = {} if reward_fun is None else {"reward_fun": reward_fun}
    st = env_cfg.sample_time
    prev = prev_res
    rows = []
    for t in range(cfg.rollout_steps):
        obs = featurize(prev, patient_basal, cgm_prev=cgm_prev, iob=iob)
        basal, raw, logp, value = sample_action(params, obs, key, step + t,
                                                scale=cfg.action_scale, mesh=mesh)
        if cfg.scale_by_basal:
            basal = basal * patient_basal
        action = CtrlAction(basal=basal, bolus=torch.zeros_like(basal))
        env_state, res, carry_res = autoreset_step(env_cfg, env_params, env_state, action,
                                                   **step_kwargs)
        reward = res.reward - cfg.done_penalty * res.done.to(value.dtype)
        rows.append(Transition(obs=obs, raw_action=raw, logp=logp, value=value, reward=reward,
                               done=res.done))
        # the carries of the next observation: the baseline is the CGM just
        # acted on, IOB decays and adds the delivered dose; a reset zeroes both
        cgm_prev = torch.where(res.done, carry_res.observation.CGM, prev.observation.CGM)
        iob = torch.where(res.done, torch.zeros_like(iob), iob_step(iob, res.insulin, st))
        # the first action of a new episode acts on its reset observation
        prev = carry_res
    traj = Transition(*(torch.stack(xs) for xs in zip(*rows)))
    return env_state, prev, cgm_prev, iob, traj


def make_train_step(cfg: PPOConfig, env_cfg, mesh=None, reward_fun=None):
    """Build the PPO iteration ``train_step(env_params, ts) -> (ts',
    metrics)`` over the eager env: :func:`_rollout` of
    ``cfg.rollout_steps`` steps, GAE, then :func:`_update` with the learner
    ``cfg.pallas_learner`` picks (K4 'step', K5 'epoch' or autograd),
    bfloat16 with ``cfg.learner_bf16``.  CUDA tensors run the kernels; CPU
    tensors their plain versions.

    ``reward_fun`` replaces the env's risk-diff reward for training;
    reference-style 1-argument rewards over the BG history are adapted by
    :func:`~simglucose_tpu_torch.envs.functional.wrap_reward_fn`.  The
    'sigmoid' decoder only (``residual_bb`` trains on the fused trainer).

    ``mesh`` (:func:`~simglucose_tpu_torch.parallel.sharding.make_mesh`)
    trains data-parallel, one rank per device: every rank calls
    ``train_step`` with its ``shard_batch`` of the env params, env state,
    previous result, keys and carries, and ``replicate``d params, optimizer
    state and generator.  The rollout and GAE are the rank's own, the
    learner is :func:`_update`'s under the mesh, and the metrics are global
    means (one all-reduce).  A mesh with ``tp > 1`` shards the batch by
    ``dp_rank`` and splits the policy over its ``tp`` ranks in the
    rollout, the bootstrap value and the (autograd) learner; the ``tp``
    ranks of one ``dp`` coordinate pass the same shard.  Not ported,
    raising NotImplementedError: ``reset_cadence > 1`` (a speed option of
    the XLA scan, on ROADMAP's "Not ported" list)."""
    if reward_fun is not None:
        reward_fun = wrap_reward_fn(reward_fun, env_cfg.window_size)
    if cfg.decoder != "sigmoid":
        raise ValueError(
            "the XLA-rollout trainer implements the 'sigmoid' decoder only; "
            "decoder='residual_bb' trains on the fused path (rl/fused.make_fused_train_step: "
            "the kernel computes the BB command in-kernel)"
        )
    if cfg.reset_cadence > 1:
        raise NotImplementedError(
            f"reset_cadence={cfg.reset_cadence} (cadenced reset sampling) is not ported: it is a "
            "speed option of the XLA scan, on ROADMAP's \"Not ported\" list; use reset_cadence=1")
    if mesh is not None:
        check_mesh(mesh)
    opt = make_optimizer(cfg)

    def train_step(env_params, ts: TrainState):
        check_action_decoder(ts.params, cfg.action_scale, cfg.scale_by_basal, "make_train_step")
        patient_basal = basal_rate(env_params.patient)
        cgm0 = ts.prev_res.observation.CGM
        cgm_prev = cgm0 if ts.cgm_prev is None else ts.cgm_prev
        iob = torch.zeros_like(cgm0) if ts.iob is None else ts.iob
        env_state, last_res, cgm_prev, iob, traj = _rollout(
            cfg, env_cfg, env_params, ts.params, ts.env_state, ts.prev_res, cgm_prev, iob,
            patient_basal, ts.key, ts.step, reward_fun=reward_fun, mesh=mesh)
        _, _, last_value = policy_apply(
            ts.params, featurize(last_res, patient_basal, cgm_prev=cgm_prev, iob=iob), mesh=mesh)
        advs, rets = _gae(cfg, traj, last_value)
        params, opt_state, aux = _update(cfg, opt, ts.params, ts.opt_state, traj, advs, rets,
                                         generator=ts.generator, mesh=mesh)
        reward_mean, done_frac = global_means(
            [traj.reward, traj.done.to(traj.reward.dtype)], mesh)
        metrics = {
            "reward_mean": reward_mean,
            "done_frac": done_frac,
            "pg_loss": aux[0].mean(),
            "v_loss": aux[1].mean(),
            "entropy": aux[2].mean(),
        }
        return ts._replace(params=params, opt_state=opt_state, env_state=env_state,
                           prev_res=last_res, step=ts.step + cfg.rollout_steps,
                           cgm_prev=cgm_prev, iob=iob), metrics

    return train_step
