"""The PPO learner's kernels, K2 to K5: host side, plain versions, wrappers.

Counterpart of ``simglucose_tpu/ops/pallas_ppo_learner.py``:

* :func:`gae_pack` (K2): generalized advantage estimation over the rollout
  and the learner's ``[2, T*B]`` advantage/return pack, column ``t*B + b``.
* :func:`ppo_grad_step_gather2` (K3): one PPO grad step over a minibatch
  gathered by shuffle-block ids from the rollout's ``[10, N]`` learner rows
  and the ``[2, N]`` advantage/return pack: forward, clipped surrogate plus
  value loss, and the hand-derived backward (the ``kernel_prep`` path).
* :func:`ppo_grad_step_gather` and :func:`ppo_grad_step` (K4): the same
  grad step over the 12-row buffer of :func:`pack_minibatch_rows` (the
  observation-plane path's ``'step'`` learner), with the loss means' 1/n
  from ``loss_rows`` where given.
* :func:`ppo_epoch_update` (K5): the whole learner, every epoch x
  minibatch grad step with the global-norm clip and Adam, in one launch,
  on the flat parameters and Adam moments of :mod:`simglucose_tpu_torch.rl.ppo`
  (the ``'epoch'`` learner).

Each wrapper takes CPU tensors to its plain PyTorch version (``*_reference``)
and CUDA tensors to its kernel in ``csrc/ppo_learner.cu``; anything else
raises.  Each kernel launch adds one to its entry of ``LAUNCHES``.  The
grad steps take ``compute_dtype`` float32 or bfloat16, as the JAX kernels
do: bfloat16 rounds both operands of every product to bfloat16 and
accumulates in float32; the activations the derivatives read and the bias
sums stay float32.  Another dtype raises.  Row 7
(the learner rows' value, the 12-row buffer's zero spare) is not an input
of the MLP: the JAX kernels multiply it by a zero column of w1 and discard
that gradient row, the port leaves it out.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from simglucose_tpu_torch.rl.policy import LOG_2PI, OBS_DIM, pack_head, round_to
from simglucose_tpu_torch.utils.profiling import span

ACTS = ("relu", "tanh")  # in the order of ppo_math.cuh's Act
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)  # PPOArgs.bf16 0 and 1
FM_ROWS = 12  # K4/K5's buffer: 0-6 obs, 7 zero spare, 8 raw, 9 logp_old, 10 adv, 11 ret

# launches of the CUDA kernels made through the wrappers; "_bf16": the
# bfloat16 instantiation of the grad-step kernels
LAUNCHES = {"gae": 0, "ppo_grad": 0, "ppo_grad12": 0, "ppo_epoch": 0, "ppo_grad_bf16": 0,
            "ppo_grad12_bf16": 0, "ppo_epoch_bf16": 0}


def _count(name: str, compute_dtype) -> None:
    LAUNCHES[name + ("_bf16" if compute_dtype == torch.bfloat16 else "")] += 1


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


_GAE_LAUNCH = None  # the library's sgt_gae_launch, taken at the first launch


def _gae_checks(reward, done, value, tail_value):
    """Raise on what K2 does not take, naming the input: tensors on more
    than one device, or not contiguous float32 ``[T, B]`` / ``[B]``."""
    _device_kind(reward, done, value, tail_value)
    T, B = reward.shape
    for name, t in (("reward", reward), ("done", done), ("value", value)):
        _check(name, t, (T, B))
    _check("tail_value", tail_value, (B,))


@span("gae")
def gae_pack(reward, done, value, tail_value, *, gamma: float, lam: float) -> torch.Tensor:
    """GAE + the ``[2, T*B]`` adv/ret pack.  ``reward``/``done``/``value``
    are ``[T, B]`` float32 (``done`` as 0/1, zeros for the continuing task;
    ``value`` may be the rollout's view of learner row 7), ``tail_value``
    ``[B]``.  CPU tensors run :func:`gae_pack_reference`; CUDA tensors the
    kernel.  The launch path reads each input's attributes once, in one
    test that falls to :func:`_gae_checks` (which raises) only when it
    fails, and takes the launcher and the stream as raw handles."""
    global _GAE_LAUNCH
    dev = reward.device
    if dev.type != "cuda":
        if _device_kind(reward, done, value, tail_value) == "cpu":
            return gae_pack_reference(reward, done, value, tail_value, gamma=gamma, lam=lam)
    shape, f32 = reward.shape, torch.float32
    if not (len(shape) == 2 and done.shape == shape and value.shape == shape
            and tail_value.shape == shape[1:]
            and reward.dtype == f32 and done.dtype == f32 and value.dtype == f32
            and tail_value.dtype == f32 and done.device == dev and value.device == dev
            and tail_value.device == dev and reward.is_contiguous() and done.is_contiguous()
            and value.is_contiguous() and tail_value.is_contiguous()):
        _gae_checks(reward, done, value, tail_value)
        raise ValueError("gae_pack: inputs K2 does not take")  # _gae_checks raises first
    if _GAE_LAUNCH is None:
        from simglucose_tpu_torch.ops.build import load_library

        _GAE_LAUNCH = load_library().sgt_gae_launch
    T, B = shape
    out = torch.empty(2, T * B, dtype=f32, device=dev)
    err = _GAE_LAUNCH(T, B, reward.data_ptr(), done.data_ptr(), value.data_ptr(),
                      tail_value.data_ptr(), gamma, gamma * lam, out.data_ptr(),
                      torch._C._cuda_getCurrentRawStream(dev.index))
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


def _compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"the grad-step kernels compute in float32 or bfloat16; got "
            f"compute_dtype={compute_dtype}")
    return compute_dtype


def _tile_forward(x, raw, w1, b1, w2, b2, w_head, b_head, log_std, act, compute_dtype):
    """:func:`tile_grads`' forward: the operands rounded to ``compute_dtype``
    (w2, w_head, x), the activations (h1 and h2 float32, h1r and h2r
    rounded), the heads mu and v, and the Gaussian's exp(-log_std), z and
    log-prob of ``raw``."""
    r = lambda t: round_to(t, compute_dtype)
    f = torch.relu if act == "relu" else torch.tanh
    w1, w2, wh, xr = r(w1), r(w2), r(w_head), r(x)
    h1 = f(w1.T @ xr + b1[:, None])  # [H, R]
    h1r = r(h1)
    h2 = f(w2.T @ h1r + b2[:, None])
    h2r = r(h2)
    hv = wh.T @ h2r + b_head[:, None]  # [2, R]
    es = torch.exp(-log_std)
    z = (raw - hv[0]) * es
    logp = -0.5 * z * z - log_std - 0.5 * LOG_2PI
    return w2, wh, xr, h1, h1r, h2, h2r, hv[0], hv[1], es, z, logp


def learner_logp(x, raw, w1, b1, w2, b2, w_head, b_head, log_std, *, act,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """The grad steps' log-prob of ``raw`` [R] at rows ``x`` [7, R]
    (feature-major) and ``compute_dtype``: the forward of
    :func:`tile_grads`, which is K3-K5's plain version.  Against the
    behaviour log-prob at unchanged params it gives the learner's epoch-0
    ratio."""
    return _tile_forward(x, raw, w1, b1, w2, b2, w_head, b_head, log_std, act,
                         _compute_dtype(compute_dtype))[-1]


def tile_grads(x, raw, logp_old, adv, ret, w1, b1, w2, b2, w_head, b_head, log_std,
               adv_mean, adv_rstd, inv_n, *, act, clip_eps, vf_coef,
               compute_dtype=torch.float32) -> PPOGradOut:
    """Forward + PPO loss + hand-derived backward over rows ``x`` [7, R]
    (feature-major) with raw / logp_old / adv / ret [R]: the JAX
    ``_tile_grads`` as tensor ops.  ``compute_dtype=torch.bfloat16`` rounds
    both operands of each product to bfloat16 (:func:`round_to`) with the
    products in float32, as ``_tile_grads(cd=bfloat16)`` does; h1 and h2
    stay float32 for the activation derivatives, and db1, db2 and db_head
    sum the unrounded values."""
    r = lambda t: round_to(t, compute_dtype)
    if act == "relu":
        fprime = lambda h: (h > 0.0).to(h.dtype)
    else:
        fprime = lambda h: 1.0 - h * h
    w2, wh, xr, h1, h1r, h2, h2r, mu, v, es, z, logp = _tile_forward(
        x, raw, w1, b1, w2, b2, w_head, b_head, log_std, act, compute_dtype)
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
    dhvr = r(dhv)
    dg2 = (wh @ dhvr) * fprime(h2)  # [H, R]
    dg2r = r(dg2)
    dg1 = (w2 @ dg2r) * fprime(h1)
    return PPOGradOut(
        dw1=xr @ r(dg1).T,
        db1=dg1.sum(1),
        dw2=h1r @ dg2r.T,
        db2=dg2.sum(1),
        dw_head=h2r @ dhvr.T,
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
    adv_mean, adv_std, *, act="relu", clip_eps=0.2, vf_coef=0.5, compute_dtype=torch.float32,
) -> PPOGradOut:
    """Plain version of K3: gather the minibatch, then :func:`tile_grads`
    over all its rows at once."""
    _check_grad_args(main_fm, advret_fm, block_rows, act)
    _compute_dtype(compute_dtype)
    bs = int(block_rows)
    mb = perm_mb.shape[0] * bs
    ls, mean, rstd, inv_n = _scalars(log_std, adv_mean, adv_std, mb, main_fm.device, main_fm.dtype)
    rows = _gather_columns(main_fm, perm_mb, bs)
    ar = _gather_columns(advret_fm, perm_mb, bs)
    return tile_grads(rows[0:OBS_DIM], rows[8], rows[9], ar[0], ar[1], w1, b1, w2, b2, w_head,
                      b_head, ls, mean, rstd, inv_n, act=act, clip_eps=clip_eps,
                      vf_coef=vf_coef, compute_dtype=compute_dtype)


class _CPPOArgs(ctypes.Structure):
    """Mirror of ``PPOArgs`` in csrc/ppo_math.cuh."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "main", "advret", "perm", "w1", "b1", "w2", "b2", "wh", "bh", "scal", "partial")]
        + [("N", ctypes.c_int64)]
        + [(n, ctypes.c_int32) for n in ("bs", "H", "act", "split")]
        + [(n, ctypes.c_float) for n in ("clip_lo", "clip_hi", "vf_coef")]
        + [("bf16", ctypes.c_int32)]
    )


def _out_len(H: int) -> int:
    return 7 * H + H + H * H + H + 2 * H + 2 + 3


def _grad_split(n_blk: int, device) -> int:
    """Work items per shuffle block of the grad-step kernels, each a
    contiguous part of its rows with its own partial: as many (up to 4) as
    the card has SMs for, so that a minibatch of fewer shuffle blocks than
    SMs still fills the card (2 for the bench shape's 64 blocks on 132
    SMs; 1 from 67 blocks up).  1 on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1
    return max(1, min(4, _sm_count(dev.index) // max(1, n_blk)))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grad_step_args(main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head,
                    log_std, adv_mean, adv_std, act, clip_eps, vf_coef, n=None, split=None,
                    compute_dtype=torch.float32):
    """The kernel's checked float32 inputs and its ``PPOArgs``: (args, the
    tensors they point into, the ``[ppo_out_len(H)]`` output, n_blk).
    ``advret_fm`` None: ``main_fm`` is the 12-row buffer (K4).  ``n``: the
    losses' row count (default: the minibatch's).  ``split``: CUDA blocks
    per shuffle block (default :func:`_grad_split`).  ``compute_dtype``
    picks the kernel's float32 or bfloat16 instantiation."""
    N = main_fm.shape[1]
    dev = main_fm.device
    H = w1.shape[1]
    if H > 128:
        raise ValueError(f"the grad-step kernel takes H <= 128; got {H}")
    bs = int(block_rows)
    n_blk = perm_mb.shape[0]
    if advret_fm is None:
        _check("packed_fm", main_fm, (FM_ROWS, N))
        advret_fm = main_fm  # the launcher reads rows 10-11 of main_fm
    else:
        _check("main_fm", main_fm, (10, N))
        _check("advret_fm", advret_fm, (2, N))
    perm = perm_mb.to(torch.int64).contiguous()
    ws = [t.to(torch.float32).contiguous() for t in (w1, b1, w2, b2, w_head, b_head)]
    for name, t, shape in zip(("w1", "b1", "w2", "b2", "w_head", "b_head"), ws,
                              ((OBS_DIM, H), (H,), (H, H), (H,), (H, 2), (2,))):
        _check(name, t, shape)
    n = n if n is not None else n_blk * bs
    scal = torch.stack(_scalars(log_std, adv_mean, adv_std, n, dev))
    L = _out_len(H)
    split = split if split is not None else _grad_split(n_blk, dev)
    partial = torch.empty(n_blk * split, L, dtype=torch.float32, device=dev)
    out = torch.empty(L, dtype=torch.float32, device=dev)
    keep = (main_fm, advret_fm, perm, *ws, scal, partial)
    a = _CPPOArgs()
    (a.main, a.advret, a.perm, a.w1, a.b1, a.w2, a.b2, a.wh, a.bh, a.scal,
     a.partial) = [t.data_ptr() for t in keep]
    a.N, a.bs, a.H, a.act, a.split = N, bs, H, ACTS.index(act), split
    a.bf16 = COMPUTE_DTYPES.index(_compute_dtype(compute_dtype))
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


@span("grad_step")
def ppo_grad_step_gather2(
    main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
    adv_mean, adv_std, *, act="relu", clip_eps=0.2, vf_coef=0.5, compute_dtype=torch.float32,
) -> PPOGradOut:
    """One fused PPO grad step over the minibatch made of shuffle blocks
    ``perm_mb`` (``block_rows`` columns each) of the rollout's ``[10, N]``
    learner rows and the ``[2, N]`` adv/ret pack.  ``adv_mean``/``adv_std``
    are the minibatch's advantage statistics; the losses are means over its
    rows.  The entropy gradient is the caller's to add.  ``compute_dtype``:
    float32 or bfloat16 products (see the module docstring).
    CPU tensors run :func:`ppo_grad_step_gather2_reference`; CUDA tensors
    the kernel (H <= 128)."""
    _check_grad_args(main_fm, advret_fm, block_rows, act)
    _compute_dtype(compute_dtype)
    kind = _device_kind(main_fm, advret_fm, perm_mb, w1, b1, w2, b2, w_head, b_head)
    if kind == "cpu":
        return ppo_grad_step_gather2_reference(
            main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
            adv_mean, adv_std, act=act, clip_eps=clip_eps, vf_coef=vf_coef,
            compute_dtype=compute_dtype,
        )
    from simglucose_tpu_torch.ops.build import load_library

    a, _keep, out, n_blk = _grad_step_args(
        main_fm, advret_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
        adv_mean, adv_std, act, clip_eps, vf_coef, compute_dtype=compute_dtype)
    dev = main_fm.device
    err = load_library().sgt_ppo_grad_launch(
        ctypes.addressof(a), n_blk, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"ppo grad-step kernel launch failed: CUDA error {err}")
    _count("ppo_grad", compute_dtype)
    return _grad_out(out, w1.shape[1])


# ---------------------------------------------------------------------------
# K4: the grad step over the 12-row buffer
# ---------------------------------------------------------------------------


def pack_minibatch_rows(obs, raw, logp, adv, ret) -> torch.Tensor:
    """``[N, OBS_DIM]`` observations and four ``[N]`` columns -> the
    ``[12, N]`` feature-major buffer of K4 and K5 (rows 0-6 obs, 7 zero, 8
    raw, 9 logp, 10 adv, 11 ret)."""
    N = obs.shape[0]
    zero = torch.zeros(1, N, dtype=obs.dtype, device=obs.device)
    cols = [c.reshape(1, N) for c in (raw, logp, adv, ret)]
    return torch.cat([obs.T, zero, *cols], dim=0)


def _check_grad12_args(packed_fm, block_rows, act, compute_dtype):
    _compute_dtype(compute_dtype)
    if act not in ACTS:
        raise ValueError(f"act must be relu|tanh; got {act!r}")
    if packed_fm.ndim != 2 or packed_fm.shape[0] != FM_ROWS:
        raise ValueError(f"packed_fm must be [{FM_ROWS}, N]; got {tuple(packed_fm.shape)}")
    N = packed_fm.shape[1]
    if N % int(block_rows):
        raise ValueError(f"N={N} not divisible by block_rows={block_rows}")
    return N


def ppo_grad_step_gather_reference(
    packed_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std, adv_mean, adv_std,
    *, act="relu", clip_eps=0.2, vf_coef=0.5, compute_dtype=torch.float32, loss_rows=None,
) -> PPOGradOut:
    """Plain version of K4: gather the minibatch's columns of the 12-row
    buffer, then :func:`tile_grads` over all its rows at once."""
    _check_grad12_args(packed_fm, block_rows, act, compute_dtype)
    bs = int(block_rows)
    n = loss_rows if loss_rows is not None else perm_mb.shape[0] * bs
    ls, mean, rstd, inv_n = _scalars(log_std, adv_mean, adv_std, n, packed_fm.device,
                                     packed_fm.dtype)
    rows = _gather_columns(packed_fm, perm_mb, bs)
    return tile_grads(rows[0:OBS_DIM], rows[8], rows[9], rows[10], rows[11], w1, b1, w2, b2,
                      w_head, b_head, ls, mean, rstd, inv_n, act=act, clip_eps=clip_eps,
                      vf_coef=vf_coef, compute_dtype=compute_dtype)


def ppo_grad_step_gather(
    packed_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std, adv_mean, adv_std,
    *, act="relu", clip_eps=0.2, vf_coef=0.5, compute_dtype=torch.float32, loss_rows=None,
) -> PPOGradOut:
    """One fused PPO grad step over the minibatch made of shuffle blocks
    ``perm_mb`` (``block_rows`` columns each) of the 12-row buffer of
    :func:`pack_minibatch_rows`.  The losses are sums scaled by
    ``1/loss_rows`` (default: the minibatch's rows; a data-parallel learner
    passes the global count).  ``compute_dtype``: float32 or bfloat16
    products.  CPU tensors run :func:`ppo_grad_step_gather_reference`; CUDA
    tensors K4 (H <= 128)."""
    _check_grad12_args(packed_fm, block_rows, act, compute_dtype)
    kind = _device_kind(packed_fm, perm_mb, w1, b1, w2, b2, w_head, b_head)
    kw = dict(act=act, clip_eps=clip_eps, vf_coef=vf_coef, loss_rows=loss_rows,
              compute_dtype=compute_dtype)
    if kind == "cpu":
        return ppo_grad_step_gather_reference(
            packed_fm, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std, adv_mean,
            adv_std, **kw)
    from simglucose_tpu_torch.ops.build import load_library

    a, _keep, out, n_blk = _grad_step_args(
        packed_fm, None, perm_mb, block_rows, w1, b1, w2, b2, w_head, b_head, log_std,
        adv_mean, adv_std, act, clip_eps, vf_coef, n=loss_rows, compute_dtype=compute_dtype)
    err = load_library().sgt_ppo_grad12_launch(
        ctypes.addressof(a), n_blk, out.data_ptr(),
        torch.cuda.current_stream(packed_fm.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"12-row grad-step kernel launch failed: CUDA error {err}")
    _count("ppo_grad12", compute_dtype)
    return _grad_out(out, w1.shape[1])


def _identity_gather(data_fm, row_tile):
    mb = data_fm.shape[1]
    rt = min(int(row_tile), mb)
    if mb % rt:
        raise ValueError(f"mb={mb} not divisible by row_tile={rt}")
    return torch.arange(mb // rt, device=data_fm.device), rt


def ppo_grad_step_reference(data_fm, w1, b1, w2, b2, w_head, b_head, log_std, adv_mean, adv_std,
                            *, row_tile=2048, **kw) -> PPOGradOut:
    """Plain version of :func:`ppo_grad_step`."""
    perm, rt = _identity_gather(data_fm, row_tile)
    return ppo_grad_step_gather_reference(data_fm, perm, rt, w1, b1, w2, b2, w_head, b_head,
                                          log_std, adv_mean, adv_std, **kw)


def ppo_grad_step(data_fm, w1, b1, w2, b2, w_head, b_head, log_std, adv_mean, adv_std,
                  *, row_tile=2048, **kw) -> PPOGradOut:
    """The grad step over a whole ``[12, mb]`` minibatch: K4 through
    :func:`ppo_grad_step_gather` with the identity gather (tiles of
    ``row_tile`` columns in order).  ``kw``: ``act``, ``clip_eps``,
    ``vf_coef``, ``compute_dtype``, ``loss_rows``."""
    perm, rt = _identity_gather(data_fm, row_tile)
    return ppo_grad_step_gather(data_fm, perm, rt, w1, b1, w2, b2, w_head, b_head, log_std,
                                adv_mean, adv_std, **kw)


# ---------------------------------------------------------------------------
# K5: the whole learner in one launch
# ---------------------------------------------------------------------------

_COOPERATIVE_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge


class _CEpochArgs(ctypes.Structure):
    """Mirror of ``EpochArgs`` in csrc/ppo_math.cuh."""

    _fields_ = (
        [("g", _CPPOArgs)]
        + [(n, ctypes.c_void_p) for n in (
            "perm", "stats", "wk", "params", "mu", "nu", "grad", "norm_part", "aux")]
        + [(n, ctypes.c_int32) for n in ("n_mb", "nblk", "grid")]
        + [(n, ctypes.c_float) for n in (
            "b1", "omb1", "b2", "omb2", "eps", "neg_lr", "max_norm", "ent_coef", "n_rows",
            "ent_const")]
    )


def _check_epoch_args(packed_fm, perm_all, block_rows, adv_mean, adv_std, params,
                      compute_dtype):
    n_mb = adv_mean.shape[0]
    if tuple(adv_std.shape) != (n_mb,) or adv_mean.ndim != 1:
        raise ValueError(f"adv_mean/adv_std must both be [n_mb]; got {tuple(adv_mean.shape)} "
                         f"and {tuple(adv_std.shape)}")
    if perm_all.ndim != 1 or n_mb == 0 or perm_all.shape[0] % n_mb:
        raise ValueError(f"perm_all [{perm_all.shape[0]}] is not {n_mb} minibatches of blocks")
    _check_grad12_args(packed_fm, block_rows, params.act, compute_dtype)
    return n_mb, perm_all.shape[0] // n_mb


def _epoch_args(cfg, opt, params, opt_state, packed_fm, perm_all, block_rows, adv_mean, adv_std,
                mb_rows, split=None, grid=None, compute_dtype=torch.float32):
    """K5's ``EpochArgs`` and the tensors they point into: the fresh flat
    params, mu and nu it updates in place, its aux output and its inputs
    and scratch (``keep``).  ``split``: work items per shuffle block
    (default :func:`_grad_split`); ``grid``: CUDA blocks that walk them
    (default one per item; the launcher lowers it to what the card holds
    at once); ``compute_dtype``: the grad step's float32 or bfloat16
    instantiation."""
    from simglucose_tpu_torch.rl.ppo import flatten_params

    n_mb = adv_mean.shape[0]
    bpm = perm_all.shape[0] // n_mb
    dev = packed_fm.device
    N = packed_fm.shape[1]
    H = params.w1.shape[1]
    if H > 128:
        raise ValueError(f"the learner kernel takes H <= 128; got {H}")
    _check("packed_fm", packed_fm, (FM_ROWS, N))
    f32 = dict(dtype=torch.float32, device=dev)
    flat = flatten_params(params).to(torch.float32).contiguous()
    P = flat.shape[0]
    mu = opt_state.mu.to(torch.float32).clone()
    nu = opt_state.nu.to(torch.float32).clone()
    _check("mu", mu, (P,))
    _check("nu", nu, (P,))
    # the weights in the grad step's layout (w_head [H, 2]: mu, v columns)
    w_head, b_head = pack_head(params)
    wk = torch.cat([params.w1.reshape(-1), params.b1, params.w2.reshape(-1), params.b2,
                    w_head.reshape(-1), b_head]).to(torch.float32).contiguous()
    # per minibatch: log_std (row 0 here, later rows from the kernel),
    # adv_mean, 1/(adv_std+1e-8) and 1/n as the grad step forms them, and
    # Adam's bias corrections in double, rounded to float32 once
    stats = torch.zeros(n_mb, 8, **f32)
    stats[0, 0] = params.log_std[0]
    stats[:, 1] = adv_mean
    stats[:, 2] = 1.0 / (adv_std.to(torch.float32) + 1e-8)
    stats[:, 3] = 1.0 / mb_rows
    t0 = opt_state.count
    stats[:, 4] = torch.tensor([1.0 - opt.b1 ** (t0 + k + 1) for k in range(n_mb)], **f32)
    stats[:, 5] = torch.tensor([1.0 - opt.b2 ** (t0 + k + 1) for k in range(n_mb)], **f32)
    perm = perm_all.to(torch.int64).contiguous()
    L = _out_len(H)
    split = split if split is not None else _grad_split(bpm, dev)
    partial = torch.empty(bpm * split, L, **f32)
    grad = torch.empty(P, **f32)
    grid = grid if grid is not None else bpm * split
    norm_part = torch.empty(grid, **f32)
    aux = torch.empty(n_mb, 4, **f32)

    e = _CEpochArgs()
    g = e.g
    g.main = packed_fm.data_ptr()
    g.perm, g.scal, g.partial = perm.data_ptr(), stats.data_ptr(), partial.data_ptr()
    offsets = (0, 7 * H, 8 * H, 8 * H + H * H, 9 * H + H * H, 11 * H + H * H)
    g.w1, g.b1, g.w2, g.b2, g.wh, g.bh = (wk.data_ptr() + 4 * o for o in offsets)
    g.N, g.bs, g.H, g.act, g.split = N, int(block_rows), H, ACTS.index(params.act), split
    g.bf16 = COMPUTE_DTYPES.index(_compute_dtype(compute_dtype))
    g.clip_lo, g.clip_hi, g.vf_coef = 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps, cfg.vf_coef
    (e.perm, e.stats, e.wk, e.params, e.mu, e.nu, e.grad, e.norm_part, e.aux) = (
        t.data_ptr() for t in (perm, stats, wk, flat, mu, nu, grad, norm_part, aux))
    e.n_mb, e.nblk, e.grid = n_mb, bpm, grid
    e.b1, e.omb1, e.b2, e.omb2 = opt.b1, 1.0 - opt.b1, opt.b2, 1.0 - opt.b2
    e.eps, e.neg_lr, e.max_norm = opt.eps, -opt.lr, opt.max_grad_norm
    e.ent_coef, e.n_rows = cfg.ent_coef, float(mb_rows)
    e.ent_const = 0.5 * math.log(2 * math.pi * math.e)
    keep = dict(params=flat, mu=mu, nu=nu, aux=aux, wk=wk, stats=stats, perm=perm,
                partial=partial, grad=grad, norm_part=norm_part, packed=packed_fm)
    return e, keep


def ppo_epoch_update_reference(cfg, opt, params, opt_state, packed_fm, perm_all, block_rows,
                               adv_mean, adv_std, *, mb_rows=None,
                               compute_dtype=torch.float32):
    """Plain version of K5: the ``'step'`` learner's loop itself, one
    :func:`ppo_grad_step_gather_reference` per minibatch, then the entropy
    term, the clip and Adam (:class:`~simglucose_tpu_torch.rl.ppo.FlatAdam`)."""
    from simglucose_tpu_torch.rl.ppo import _grad_step_updates

    n_mb, bpm = _check_epoch_args(packed_fm, perm_all, block_rows, adv_mean, adv_std, params,
                                  compute_dtype)
    mb_rows = mb_rows if mb_rows is not None else bpm * int(block_rows)
    return _grad_step_updates(cfg, opt, params, opt_state, perm_all, adv_mean, adv_std, mb_rows,
                              ppo_grad_step_gather_reference, packed_fm, block_rows=block_rows,
                              compute_dtype=compute_dtype, loss_rows=mb_rows)


def ppo_epoch_update(cfg, opt, params, opt_state, packed_fm, perm_all, block_rows, adv_mean,
                     adv_std, *, mb_rows=None, compute_dtype=torch.float32):
    """The whole PPO learner: for each minibatch k (``perm_all`` holds its
    ``bpm`` shuffle-block ids at ``[k*bpm, (k+1)*bpm)``, ``adv_mean[k]`` /
    ``adv_std[k]`` its advantage statistics), the grad step over the 12-row
    buffer, the entropy term, the global-norm clip and Adam, on the flat
    parameters and the Adam moments in ravel order.  ``cfg`` (a PPOConfig)
    gives clip_eps, vf_coef and ent_coef; ``opt`` (a FlatAdam) lr,
    max_grad_norm, betas and eps; ``compute_dtype`` the grad steps' float32
    or bfloat16 products.  Returns (params, opt_state with the count
    advanced by the minibatches, aux ``[n_mb, 4]``: pg loss, value loss,
    entropy at the step's log_std, gradient norm before the clip).

    CPU tensors run :func:`ppo_epoch_update_reference`; CUDA tensors K5 in
    one cooperative launch of as many blocks as the card holds at once, at
    most the ``bpm * _grad_split(bpm)`` work items of a minibatch, which
    they walk in turn; it raises where not even one block fits on an SM
    (there is no fallback)."""
    n_mb, bpm = _check_epoch_args(packed_fm, perm_all, block_rows, adv_mean, adv_std, params,
                                  compute_dtype)
    mb_rows = mb_rows if mb_rows is not None else bpm * int(block_rows)
    kind = _device_kind(packed_fm, perm_all, adv_mean, adv_std, opt_state.mu, opt_state.nu,
                        *params.leaves())
    if kind == "cpu":
        return ppo_epoch_update_reference(cfg, opt, params, opt_state, packed_fm, perm_all,
                                          block_rows, adv_mean, adv_std, mb_rows=mb_rows,
                                          compute_dtype=compute_dtype)
    from simglucose_tpu_torch.ops.build import load_library
    from simglucose_tpu_torch.rl.ppo import AdamState, unflatten_params

    e, keep = _epoch_args(cfg, opt, params, opt_state, packed_fm, perm_all, block_rows,
                          adv_mean, adv_std, mb_rows, compute_dtype=compute_dtype)
    dev = packed_fm.device
    err = load_library().sgt_ppo_epoch_launch(ctypes.addressof(e),
                                              torch.cuda.current_stream(dev).cuda_stream)
    if err == _COOPERATIVE_TOO_LARGE:
        raise RuntimeError(
            f"a block of the learner kernel at H={e.g.H} does not fit on an SM of this card; use "
            f"pallas_learner='step'")
    if err != 0:
        raise RuntimeError(f"learner kernel launch failed: CUDA error {err}")
    _count("ppo_epoch", compute_dtype)
    return (unflatten_params(keep["params"], params),
            AdamState(opt_state.count + e.n_mb, keep["mu"], keep["nu"]), keep["aux"])
