"""The PPO learner's kernels, K2 and K3: host side, plain versions, wrappers.

Counterpart of ``simglucose_tpu/ops/pallas_ppo_learner.py`` for the paths
the fused trainer runs (``kernel_prep``):

* :func:`gae_pack` (K2): generalized advantage estimation over the rollout
  and the learner's ``[2, T*B]`` advantage/return pack, column ``t*B + b``.
* :func:`ppo_grad_step_gather2` (K3): one PPO grad step over a minibatch
  gathered by shuffle-block ids from the rollout's ``[10, N]`` learner rows
  and the ``[2, N]`` advantage/return pack: forward, clipped surrogate plus
  value loss, and the hand-derived backward.

Each wrapper takes CPU tensors to its plain PyTorch version (``*_reference``)
and CUDA tensors to its kernel in ``csrc/ppo_learner.cu``; anything else
raises.  Each kernel launch adds one to ``LAUNCHES["gae"]`` or
``LAUNCHES["ppo_grad"]``.  The row-7 value of the learner rows is not an
input of the MLP: the JAX kernel multiplies it by a zero column of w1 and
discards that gradient row, the port leaves it out.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from simglucose_tpu_torch.rl.policy import LOG_2PI, OBS_DIM

ACTS = ("relu", "tanh")  # in the order of ppo_math.cuh's Act

# launches of the CUDA kernels made through the wrappers
LAUNCHES = {"gae": 0, "ppo_grad": 0}


class PPOGradOut(NamedTuple):
    """Gradients in PolicyParams leaf shapes + loss sums (the caller turns
    sums into means and adds the entropy gradient)."""

    dw1: torch.Tensor  # [OBS_DIM, H]
    db1: torch.Tensor  # [H]
    dw2: torch.Tensor  # [H, H]
    db2: torch.Tensor  # [H]
    dw_head: torch.Tensor  # [H, 2]  (columns: mu, v)
    db_head: torch.Tensor  # [2]
    dlog_std: torch.Tensor  # [] pg part only
    pg_sum: torch.Tensor  # [] sum of -min(pg1, pg2)
    v_sum: torch.Tensor  # [] sum of 0.5*(v-ret)^2


def _device_kind(*tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError(f"inputs must all lie on the CPU or all on one CUDA device; got {kinds}")


def _check(name, t, shape, dtype=torch.float32):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}; "
            f"got {tuple(t.shape)} {t.dtype} (contiguous={t.is_contiguous()})"
        )


# ---------------------------------------------------------------------------
# K2: GAE
# ---------------------------------------------------------------------------


def gae_pack_reference(reward, done, value, tail_value, *, gamma: float, lam: float):
    """Plain version of K2: the sequential reverse recurrence of the JAX
    ``_gae_kernel``, ``delta = r + gamma v' (1-d) - v``, ``adv = delta +
    gamma lam (1-d) adv'``, with gamma and gamma*lam rounded to float32
    once.  Returns ``[2, T*B]`` (advantages, returns)."""
    T, B = reward.shape
    gl = gamma * lam
    adv_next = torch.zeros_like(tail_value)
    v_next = tail_value
    out = torch.empty(2, T, B, dtype=reward.dtype, device=reward.device)
    for t in range(T - 1, -1, -1):
        nt = 1.0 - done[t]
        v_t = value[t]
        delta = reward[t] + gamma * v_next * nt - v_t
        adv = delta + gl * nt * adv_next
        out[0, t] = adv
        out[1, t] = adv + v_t
        adv_next = adv
        v_next = v_t
    return out.reshape(2, T * B)


def gae_pack(reward, done, value, tail_value, *, gamma: float, lam: float) -> torch.Tensor:
    """GAE + the ``[2, T*B]`` adv/ret pack.  ``reward``/``done``/``value``
    are ``[T, B]`` float32 (``done`` as 0/1, zeros for the continuing task;
    ``value`` may be the rollout's view of learner row 7), ``tail_value``
    ``[B]``.  CPU tensors run :func:`gae_pack_reference`; CUDA tensors the
    kernel."""
    kind = _device_kind(reward, done, value, tail_value)
    if kind == "cpu":
        return gae_pack_reference(reward, done, value, tail_value, gamma=gamma, lam=lam)
    from simglucose_tpu_torch.ops.build import load_library

    T, B = reward.shape
    for name, t in (("reward", reward), ("done", done), ("value", value)):
        _check(name, t, (T, B))
    _check("tail_value", tail_value, (B,))
    out = torch.empty(2, T * B, dtype=torch.float32, device=reward.device)
    err = load_library().sgt_gae_launch(
        T, B, reward.data_ptr(), done.data_ptr(), value.data_ptr(), tail_value.data_ptr(),
        gamma, gamma * lam, out.data_ptr(), torch.cuda.current_stream(reward.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: CUDA error {err}")
    LAUNCHES["gae"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: the fused PPO grad step
# ---------------------------------------------------------------------------


def _gather_columns(buf, perm_mb, block_rows):
    """The minibatch's columns of ``buf`` [rows, N]: shuffle blocks
    ``perm_mb`` of ``block_rows`` columns each, in order."""
    idx = (perm_mb.to(torch.int64)[:, None] * block_rows
           + torch.arange(block_rows, device=buf.device)).reshape(-1)
    return buf[:, idx]


def tile_grads(x, raw, logp_old, adv, ret, w1, b1, w2, b2, w_head, b_head, log_std,
               adv_mean, adv_rstd, inv_n, *, act, clip_eps, vf_coef) -> PPOGradOut:
    """Forward + PPO loss + hand-derived backward over rows ``x`` [7, R]
    (feature-major) with raw / logp_old / adv / ret [R]: the JAX
    ``_tile_grads`` as tensor ops."""
    if act == "relu":
        f = torch.relu
        fprime = lambda h: (h > 0.0).to(h.dtype)
    else:
        f = torch.tanh
        fprime = lambda h: 1.0 - h * h
    h1 = f(w1.T @ x + b1[:, None])  # [H, R]
    h2 = f(w2.T @ h1 + b2[:, None])
    hv = w_head.T @ h2 + b_head[:, None]  # [2, R]
    mu, v = hv[0], hv[1]
    es = torch.exp(-log_std)
    z = (raw - mu) * es
    logp = -0.5 * z * z - log_std - 0.5 * LOG_2PI
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv_mean) * adv_rstd
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv_n
    in_bounds = ((ratio >= 1.0 - clip_eps) & (ratio <= 1.0 + clip_eps)).to(x.dtype)
    g_min = torch.where(pg1 <= pg2, torch.ones_like(in_bounds), in_bounds)
    dratio = (-inv_n) * adv_n * g_min
    dlogp = dratio * ratio
    dmu = dlogp * z * es
    dv = (vf_coef * inv_n) * (v - ret)
    dhv = torch.stack([dmu, dv])  # [2, R]
    dg2 = (w_head @ dhv) * fprime(h2)  # [H, R]
    dg1 = (w2 @ dg2) * fprime(h1)
    return PPOGradOut(
        dw1=x @ dg1.T,
        db1=dg1.sum(1),
        dw2=h1 @ dg2.T,
        db2=dg2.sum(1),
        dw_head=h2 @ dhv.T,
        db_head=dhv.sum(1),
        dlog_std=(dlogp * (z * z - 1.0)).sum(),
        pg_sum=(-torch.minimum(pg1, pg2)).sum(),
        v_sum=(0.5 * (v - ret) ** 2).sum(),
    )


def _scalars(log_std, adv_mean, adv_std, n, device, dtype=torch.float32):
    """(log_std, adv_mean, 1/(adv_std + 1e-8), 1/n) as 0-dim tensors on
    ``device`` (no host round trip for device inputs)."""
    sc = lambda x: torch.as_tensor(x, device=device).to(dtype).reshape(())
    inv_n = torch.full((), 1.0 / n, dtype=dtype, device=device)
    return sc(log_std), sc(adv_mean), 1.0 / (sc(adv_std) + 1e-8), inv_n


def _check_grad_args(main_fm, advret_fm, block_rows, act):
    if act not in ACTS:
        raise ValueError(f"act must be relu|tanh; got {act!r}")
    if main_fm.ndim != 2 or main_fm.shape[0] != 10:
        raise ValueError(f"main_fm must be [10, N]; got {tuple(main_fm.shape)}")
    N = main_fm.shape[1]
    if tuple(advret_fm.shape) != (2, N):
        raise ValueError(f"advret_fm must be [2, {N}]; got {tuple(advret_fm.shape)}")
    if N % int(block_rows):
        raise ValueError(f"N={N} not divisible by block_rows={block_rows}")
    return N


def ppo_grad_step_gather2_reference(
    main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
    adv_mean, adv_std, *, act="relu", clip_eps=0.2, vf_coef=0.5,
) -> PPOGradOut:
    """Plain version of K3: gather the minibatch, then :func:`tile_grads`
    over all its rows at once."""
    _check_grad_args(main_fm, advret_fm, block_rows, act)
    bs = int(block_rows)
    mb = perm_mb.shape[0] * bs
    ls, mean, rstd, inv_n = _scalars(log_std, adv_mean, adv_std, mb, main_fm.device, main_fm.dtype)
    rows = _gather_columns(main_fm, perm_mb, bs)
    ar = _gather_columns(advret_fm, perm_mb, bs)
    return tile_grads(rows[0:OBS_DIM], rows[8], rows[9], ar[0], ar[1], w1, b1, w2, b2, w_head,
                      b_head, ls, mean, rstd, inv_n, act=act, clip_eps=clip_eps,
                      vf_coef=vf_coef)


class _CPPOArgs(ctypes.Structure):
    """Mirror of ``PPOArgs`` in csrc/ppo_math.cuh."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "main", "advret", "perm", "w1", "b1", "w2", "b2", "wh", "bh", "scal", "partial")]
        + [("N", ctypes.c_int64)]
        + [(n, ctypes.c_int32) for n in ("bs", "H", "act")]
        + [(n, ctypes.c_float) for n in ("clip_lo", "clip_hi", "vf_coef")]
    )


def _out_len(H: int) -> int:
    return 7 * H + H + H * H + H + 2 * H + 2 + 3


def _grad_step_args(main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head,
                    log_std, adv_mean, adv_std, act, clip_eps, vf_coef):
    """The kernel's checked float32 inputs and its ``PPOArgs``: (args, the
    tensors they point into, the ``[ppo_out_len(H)]`` output, n_blk)."""
    N = main_fm.shape[1]
    dev = main_fm.device
    H = w1.shape[1]
    if H > 128:
        raise ValueError(f"the grad-step kernel takes H <= 128; got {H}")
    bs = int(block_rows)
    n_blk = perm_mb.shape[0]
    _check("main_fm", main_fm, (10, N))
    _check("advret_fm", advret_fm, (2, N))
    perm = perm_mb.to(torch.int64).contiguous()
    ws = [t.to(torch.float32).contiguous() for t in (w1, b1, w2, b2, w_head, b_head)]
    for name, t, shape in zip(("w1", "b1", "w2", "b2", "w_head", "b_head"), ws,
                              ((OBS_DIM, H), (H,), (H, H), (H,), (H, 2), (2,))):
        _check(name, t, shape)
    scal = torch.stack(_scalars(log_std, adv_mean, adv_std, n_blk * bs, dev))
    L = _out_len(H)
    partial = torch.empty(n_blk, L, dtype=torch.float32, device=dev)
    out = torch.empty(L, dtype=torch.float32, device=dev)
    keep = (main_fm, advret_fm, perm, *ws, scal, partial)
    a = _CPPOArgs()
    (a.main, a.advret, a.perm, a.w1, a.b1, a.w2, a.b2, a.wh, a.bh, a.scal,
     a.partial) = [t.data_ptr() for t in keep]
    a.N, a.bs, a.H, a.act = N, bs, H, ACTS.index(act)
    a.clip_lo, a.clip_hi, a.vf_coef = 1.0 - clip_eps, 1.0 + clip_eps, vf_coef
    return a, keep, out, n_blk


def _grad_out(out, H) -> PPOGradOut:
    """The kernel's flat output as PPOGradOut views."""
    parts = torch.split(out, [7 * H, H, H * H, H, 2 * H, 2, 1, 1, 1])
    return PPOGradOut(
        dw1=parts[0].view(OBS_DIM, H), db1=parts[1], dw2=parts[2].view(H, H), db2=parts[3],
        dw_head=parts[4].view(H, 2), db_head=parts[5], dlog_std=parts[6][0],
        pg_sum=parts[7][0], v_sum=parts[8][0],
    )


def ppo_grad_step_gather2(
    main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
    adv_mean, adv_std, *, act="relu", clip_eps=0.2, vf_coef=0.5,
) -> PPOGradOut:
    """One fused PPO grad step over the minibatch made of shuffle blocks
    ``perm_mb`` (``block_rows`` columns each) of the rollout's ``[10, N]``
    learner rows and the ``[2, N]`` adv/ret pack.  ``adv_mean``/``adv_std``
    are the minibatch's advantage statistics; the losses are means over its
    rows.  The entropy gradient is the caller's to add.
    CPU tensors run :func:`ppo_grad_step_gather2_reference`; CUDA tensors
    the kernel (float32, H <= 128)."""
    _check_grad_args(main_fm, advret_fm, block_rows, act)
    kind = _device_kind(main_fm, advret_fm, perm_mb, w1, b1, w2, b2, w_head, b_head)
    if kind == "cpu":
        return ppo_grad_step_gather2_reference(
            main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
            adv_mean, adv_std, act=act, clip_eps=clip_eps, vf_coef=vf_coef,
        )
    from simglucose_tpu_torch.ops.build import load_library

    a, _keep, out, n_blk = _grad_step_args(
        main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
        adv_mean, adv_std, act, clip_eps, vf_coef)
    dev = main_fm.device
    err = load_library().sgt_ppo_grad_launch(
        ctypes.addressof(a), n_blk, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"ppo grad-step kernel launch failed: CUDA error {err}")
    LAUNCHES["ppo_grad"] += 1
    return _grad_out(out, w1.shape[1])
