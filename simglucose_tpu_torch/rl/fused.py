"""Fused PPO training: the rollout kernel with the policy inside (K1b), then
the learner, one iteration per call.

Counterpart of ``simglucose_tpu/rl/fused.py``, on its two paths:

* ``kernel_prep``: the rollout writes the learner's rows (features, value,
  raw action, behaviour log-prob) and the bootstrap value itself, GAE (K2)
  packs advantages and returns beside them, and each minibatch grad step
  (K3) gathers its shuffle blocks straight from those two buffers.
* the observation-plane path: the rollout writes the controller's
  observation planes and raw actions; the features, log-probs and values
  are recomputed at the rollout's params (plain matmuls, at the learner's
  compute dtype, so that the epoch-0 ratio is 1 with ``learner_bf16``
  too), GAE runs in plain torch, and ``_update`` runs the learner
  ``PPOConfig.pallas_learner`` picks: the 12-row grad step (K4) per
  minibatch, the whole learner in one launch (K5), or autograd of the loss.

With a ``mesh`` (:mod:`simglucose_tpu_torch.parallel`, one rank per
device) the observation-plane path runs data-parallel: each rank rolls out
its rows of the cohort (K1b through
:func:`~simglucose_tpu_torch.ops.rollout.make_sharded_rollout`, weights
replicated) and the learner is ``rl/ppo.py::_update`` under the mesh.
Under ``tp > 1`` the ranks of one ``dp`` coordinate roll out the same rows
with the whole policy, and the plane-prep forward and the learner split
the policy over them.

Episode state persists across iterations (``state_f``/``state_i``), so
episodes are not cut at ``rollout_steps``.  On CUDA tensors every kernel
stage is a kernel of ``csrc/``; on CPU tensors the same iteration runs
their plain PyTorch versions.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from simglucose_tpu_torch.ops.ppo_learner import gae_pack
from simglucose_tpu_torch.ops.rollout import (
    LANES,
    NS_F,
    NS_I,
    config_for_sensor,
    make_sharded_rollout,
    pack_policy_weights,
    packed_basal,
    rollout,
)
from simglucose_tpu_torch.parallel.sharding import resolve_mesh
from simglucose_tpu_torch.rl.policy import (
    PolicyParams,
    check_action_decoder,
    featurize_parts,
    gaussian_logprob,
    policy_apply,
)
from simglucose_tpu_torch.rl.ppo import (
    AdamState,
    PPOConfig,
    Transition,
    _gae,
    _update,
    _update_packed,
    global_means,
    learner_dtype,
    make_optimizer,
)
from simglucose_tpu_torch.utils.profiling import span


class FusedTrainState(NamedTuple):
    params: PolicyParams
    opt_state: AdamState
    state_f: torch.Tensor  # simulator state, [NS_F, rows, 128] f32
    state_i: torch.Tensor  # [NS_I, rows, 128] i32
    init: int  # 1 before the first rollout (draw fresh episodes)
    # draws each iteration's rollout key and the shuffle permutations; it
    # advances in place (the JAX state carries a key instead)
    generator: torch.Generator


def init_fused_state(params: PolicyParams, opt_state: AdamState, batch: int,
                     generator: torch.Generator, mesh=None) -> FusedTrainState:
    """A fresh training state on the params' device; ``generator`` is a
    CPU ``torch.Generator``.  With a ``mesh`` the simulator state holds
    this rank's rows of the global ``batch`` (those of its ``dp``
    coordinate); params, optimizer state and generator are taken as
    replicated."""
    n = resolve_mesh(mesh, allow_tp=True).dp
    if batch % (n * LANES):
        raise ValueError(f"batch {batch} must divide into {n} ranks x {LANES} lanes")
    rows = batch // LANES // n
    dev = params.w1.device
    return FusedTrainState(
        params=params,
        opt_state=opt_state,
        state_f=torch.zeros(NS_F, rows, LANES, dtype=torch.float32, device=dev),
        state_i=torch.zeros(NS_I, rows, LANES, dtype=torch.int32, device=dev),
        init=1,
        generator=generator,
    )


def fused_rollout_config(cfg: PPOConfig, hidden: int = 64, sensor: str = "Dexcom",
                         reward_kind: str = "risk_diff", continuing: bool = False,
                         overrides: Optional[dict] = None, kernel_prep: bool = True):
    """The rollout config of :func:`make_fused_train_step`'s K1b call:
    learner rows with ``kernel_prep``, else observation planes."""
    over = dict(
        controller="nn",
        nn_hidden=hidden,
        nn_action_scale=cfg.action_scale,
        nn_scale_by_basal=cfg.scale_by_basal,
        nn_decoder=cfg.decoder,
        n_steps=cfg.rollout_steps,
        reward_kind=reward_kind,
        autoreset=not continuing,
        nn_emit_learner_rows=kernel_prep,
    )
    over.update(overrides or {})
    return config_for_sensor(sensor, **over)


def _features(octrl, oins, ocho, oprev, oiob, basal):
    """The policy's features from the rollout's observation planes
    (``basal`` [B] broadcasts over the time axis)."""
    return featurize_parts(octrl, oins, ocho, oprev, oiob, basal)


def plane_transition(cfg: PPOConfig, params: PolicyParams, traj: dict, basal: torch.Tensor,
                     reward: torch.Tensor, done: torch.Tensor, mesh=None):
    """The observation-plane path's transition: the features of a
    plane-mode rollout ``traj``, and the log-probs of its raw actions and
    its values recomputed at ``params`` at the learner's compute dtype
    (:func:`~simglucose_tpu_torch.rl.ppo.learner_dtype`), so that the
    epoch-0 ratio at unchanged params is 1.  ``mesh`` splits the policy
    (``policy_apply``).  Returns the ``[T, B]`` Transition and the
    bootstrap value ``[B]``."""
    cdt = learner_dtype(cfg)
    planes = ("octrl", "oins", "ocho", "oprev", "oiob")
    obs = _features(*(traj[k] for k in planes), basal)  # [T, B, OBS_DIM]
    mu, log_std, value = policy_apply(params, obs, compute_dtype=cdt, mesh=mesh)
    logp = gaussian_logprob(mu, log_std, traj["raw"])
    tail_obs = _features(*(traj["tail_" + k] for k in planes), basal)
    _, _, last_value = policy_apply(params, tail_obs, compute_dtype=cdt, mesh=mesh)
    return Transition(obs=obs, raw_action=traj["raw"], logp=logp, value=value, reward=reward,
                      done=done), last_value


def make_fused_train_step(
    cfg: PPOConfig,
    batch: int,
    sensor: str = "Dexcom",
    hidden: int = 64,
    mesh=None,
    reward_kind: str = "risk_diff",
    continuing: bool = False,
    reward_fn=None,
    stages: str = "full",
    kernel_prep: Optional[bool] = None,
    rollout_overrides: Optional[dict] = None,
):
    """Build the fused PPO iteration ``train_step(packed_params, ts) ->
    (ts', metrics)``: ``packed_params`` from
    :func:`simglucose_tpu_torch.ops.rollout.pack_params`, ``ts`` a
    :class:`FusedTrainState`.  The policy must be relu of width ``hidden``.

    ``continuing=True`` trains the continuing task: no auto-reset and no
    GAE terminals.  ``reward_fn(traj) -> [T, B]`` replaces the kernel's
    reward.  ``stages`` cuts the iteration for profiling: 'rollout' (the
    kernel and the state carry), 'forward' (+ GAE), 'full' (the training
    step; the others leave params and optimizer state as they are).
    ``rollout_overrides`` updates fields of the rollout config.

    ``kernel_prep`` picks the path (see the module docstring).  It
    defaults to True exactly where it is eligible: no mesh, and
    ``PPOConfig.pallas_learner`` True or 'step' with an f32 learner (the
    kernel's behaviour log-probs are float32, a bf16 learner's forward
    would break the epoch-0 ratio); asking for it elsewhere raises
    ValueError, as in the JAX package.

    ``mesh`` trains data-parallel over its ranks on the observation-plane
    path: ``batch`` is global, every rank passes the same global
    ``packed_params`` and its own state (:func:`init_fused_state` with the
    mesh), each rank rolls out its rows, and the metrics are global means.
    With ``tp > 1`` the rows are those of the rank's ``dp`` coordinate, K1b
    runs on them with the whole policy, and the plane prep and the
    (autograd) learner split the policy over ``'tp'``."""
    if stages not in ("rollout", "forward", "full"):
        raise ValueError(f"stages must be rollout|forward|full; got {stages!r}")
    prep_eligible = mesh is None and cfg.pallas_learner in (True, "step") and not cfg.learner_bf16
    if kernel_prep is None:
        kernel_prep = prep_eligible
    elif kernel_prep and not prep_eligible:
        raise ValueError(
            "kernel_prep=True needs the single-device grad-step learner (mesh=None, "
            "PPOConfig.pallas_learner in (True, 'step')) with an f32 learner "
            "(learner_bf16=False); the mesh trainer and the 'epoch' learner use the "
            "observation-plane prep"
        )
    rcfg = fused_rollout_config(cfg, hidden, sensor, reward_kind, continuing, rollout_overrides,
                                kernel_prep)
    if mesh is None:
        run, lanes = functools.partial(rollout, rcfg), slice(None)
    else:
        run, per = make_sharded_rollout(rcfg, batch, mesh), batch // mesh.dp
        lanes = slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
    opt = make_optimizer(cfg)

    @span("fused.iteration")
    def train_step(packed_params: torch.Tensor, ts: FusedTrainState):
        check_action_decoder(ts.params, cfg.action_scale, cfg.scale_by_basal,
                             "make_fused_train_step", decoder=cfg.decoder)
        with span("fused.rollout"):
            # a fresh rollout key per iteration
            seed = tuple(int(k) for k in torch.randint(0, 2**31 - 1, (2,),
                                                       generator=ts.generator))
            traj = run(packed_params, seed, state=(ts.state_f, ts.state_i), init=ts.init,
                       weights=pack_policy_weights(ts.params))
        carried = ts._replace(state_f=traj["state_f"], state_i=traj["state_i"], init=0)
        done = traj["done"].to(torch.float32)
        if stages == "rollout":
            return carried, dict(zip(("reward_mean", "done_frac"),
                                     global_means([traj["reward"], done], mesh)))
        base_reward = traj["reward"] if reward_fn is None else reward_fn(traj)
        reward = (base_reward - cfg.done_penalty * done).contiguous()
        gae_done = torch.zeros_like(done) if continuing else done
        metrics = dict(zip(("reward_mean", "done_frac"), global_means([reward, done], mesh)))
        if kernel_prep:
            # traj["value"] is a view of learner row 7: no copy of the buffer
            advret = gae_pack(reward, gae_done, traj["value"], traj["tail_value"],
                              gamma=cfg.gamma, lam=cfg.lam)
            if stages == "forward":
                metrics.update(adv_mean=advret[0].mean(), ret_mean=advret[1].mean(),
                               logp_mean=traj["learner"][9].mean())
                return carried, metrics
            with span("fused.learner"):
                params, opt_state, aux = _update_packed(
                    cfg, opt, ts.params, ts.opt_state, traj["learner"], advret,
                    generator=ts.generator,
                )
        else:
            tr, last_value = plane_transition(cfg, ts.params, traj,
                                              packed_basal(packed_params)[lanes], reward, gae_done,
                                              mesh=mesh)
            advs, rets = _gae(cfg, tr, last_value)
            if stages == "forward":
                metrics.update(zip(("adv_mean", "ret_mean", "logp_mean"),
                                   global_means([advs, rets, tr.logp], mesh)))
                return carried, metrics
            with span("fused.learner"):
                params, opt_state, aux = _update(cfg, opt, ts.params, ts.opt_state, tr, advs,
                                                 rets, generator=ts.generator, mesh=mesh)
        metrics.update(pg_loss=aux[0].mean(), v_loss=aux[1].mean(), entropy=aux[2].mean())
        return carried._replace(params=params, opt_state=opt_state), metrics

    return train_step


def make_fused_train_loop(cfg: PPOConfig, batch: int, iters_per_call: int, **kwargs):
    """``iters_per_call`` fused train steps per call, in a Python loop.
    Returns ``loop(packed_params, ts) -> (ts', metrics)`` with each metric
    stacked ``[iters_per_call]``."""
    step = make_fused_train_step(cfg, batch, **kwargs)

    def loop(packed_params, ts: FusedTrainState):
        history = []
        for _ in range(iters_per_call):
            ts, m = step(packed_params, ts)
            history.append(m)
        return ts, {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return loop
