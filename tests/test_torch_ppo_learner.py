"""Port learner kernels K2 (gae_pack), K3 (ppo_grad_step_gather2) and K4
(ppo_grad_step_gather, ppo_grad_step), plain versions, vs the JAX kernels
in interpret mode and vs autodiff; the optimizer vs optax.

Tolerances: gae_pack runs the JAX kernel's recurrence in the same order,
so rtol 1e-6 / atol 1e-6 over 8 steps (float32 libm-free arithmetic; XLA's
CPU fuses the step's two multiply-adds, which over 64 steps or more moves
results by up to ~2e-6, so those horizons are held to 1e-5); against the associative-scan ``_gae`` (sums reassociated) rtol
1e-5 / atol 1e-5.  The grad step against the JAX kernel at float32 rtol
2e-4 / atol 1e-5 (tests/test_pallas_ppo_learner.py's tolerance: row sums
in other orders), K4 the same, and K4 against K3 on the same rows exactly
(the same operations on the same values); against torch.autograd of the port's own loss at float64
rtol 1e-9 / atol 1e-12 (same math, no float32 rounding).  The optimizer
against optax at float32 rtol 1e-6 / atol 1e-9 per step."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simglucose_tpu.ops import pallas_ppo_learner as jl
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch.ops import ppo_learner as tl
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)


def _rollout_like(rng, T, B, dtype=np.float32):
    reward = rng.normal(0, 1, (T, B)).astype(dtype)
    done = (rng.uniform(size=(T, B)) < 0.05).astype(dtype)
    value = rng.normal(0, 2, (T, B)).astype(dtype)
    tail = rng.normal(0, 2, B).astype(dtype)
    return reward, done, value, tail


def test_gae_pack_matches_jax_kernel_and_gae():
    rng = np.random.default_rng(0)
    T, B = 8, 256
    reward, done, value, tail = _rollout_like(rng, T, B)
    got = tl.gae_pack(*(torch.from_numpy(a) for a in (reward, done, value, tail)),
                      gamma=0.99, lam=0.95)
    ref = jl.gae_pack(*(jnp.asarray(a) for a in (reward, done, value, tail)), gamma=0.99,
                      lam=0.95, interpret=True)
    assert got.shape == (2, T * B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    cfg = tppo.PPOConfig()
    tr_t = tppo.Transition(None, None, None, torch.from_numpy(value), torch.from_numpy(reward),
                           torch.from_numpy(done))
    adv_t, ret_t = tppo._gae(cfg, tr_t, torch.from_numpy(tail))
    tr_j = jppo.Transition(None, None, None, jnp.asarray(value), jnp.asarray(reward),
                           jnp.asarray(done))
    adv_j, ret_j = jppo._gae(jppo.PPOConfig(), tr_j, jnp.asarray(tail))
    for a, b in ((adv_t, adv_j), (ret_t, ret_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), torch.stack([adv_t, ret_t]).reshape(2, -1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", [(1, 128), (64, 256), (77, 128)])
def test_gae_pack_chunk_lengths_match_jax_kernel(T, B):
    """The horizons the card's K2 walks in 32-row chunks (one row; two full
    chunks; two and a 13-row one) against the JAX kernel in interpret mode,
    done flags on both sides of each chunk boundary.  rtol 1e-5 / atol
    1e-5, not the 8-step test's 1e-6: XLA's CPU fuses both multiply-adds of
    the JAX kernel's step (its result equals a float32 evaluation with
    fused multiply-adds bit for bit), the plain version rounds each
    operation, and the gap grows with the walk (1.9e-6 at T=64)."""
    rng = np.random.default_rng(T)
    reward, done, value, tail = _rollout_like(rng, T, B)
    for t in (31, 32, 63, 64, T - 1):
        if t < T:
            done[t, t % 5::5] = 1.0
    got = tl.gae_pack(*(torch.from_numpy(a) for a in (reward, done, value, tail)),
                      gamma=0.99, lam=0.95)
    ref = jax.jit(functools.partial(jl.gae_pack, gamma=0.99, lam=0.95, interpret=True))(
        *(jnp.asarray(a) for a in (reward, done, value, tail)))
    assert got.shape == (2, T * B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", [0, 1, 3])
def test_gae_pack_refuses_inputs_off_the_cpu_and_the_card(which):
    """An input on another device (here ``meta``) raises, whichever it is,
    before any plain version or kernel runs."""
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a) for a in _rollout_like(rng, 4, 128)]
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on one CUDA device"):
        tl.gae_pack(*args, gamma=0.99, lam=0.95)


def _learner_rows(rng, N, dtype=np.float32, logp_shift=0.0):
    main = np.zeros((10, N), dtype)
    main[0:7] = rng.normal(0, 1, (7, N))
    main[7] = rng.normal(0, 3, N)  # the value row: not an input of the MLP
    main[8] = rng.normal(-1, 1, N)
    main[9] = rng.normal(-1.2, 0.3, N) + logp_shift
    advret = rng.normal(0, 1, (2, N)).astype(dtype)
    return main, advret


def _policy(seed, H, act, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = dict(w1=(7, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,),
                  log_std=(1,), w_v=(H, 1), b_v=(1,))
    arrays = [rng.normal(0, np.sqrt(1.0 / s[0]), s).astype(dtype) for s in shapes.values()]
    arrays[6][:] = -0.5
    return arrays


def _grad_args(p, perm_mb, bs, adv_mb):
    w_head = torch.cat([p.w_mu, p.w_v], dim=1)
    b_head = torch.cat([p.b_mu, p.b_v])
    return (perm_mb, bs, p.w1, p.b1, p.w2, p.b2, w_head, b_head, p.log_std[0],
            adv_mb.mean(), adv_mb.std(correction=0))


def test_grad_step_matches_jax_kernel():
    """The same rows, permutation and weights through the JAX kernel
    (interpret mode, float32 compute) and the port's plain version."""
    rng = np.random.default_rng(1)
    N, bs, H = 2048, 64, 16
    main, advret = _learner_rows(rng, N)
    arrays = _policy(2, H, "relu")
    perm_mb = rng.permutation(N // bs)[:8]
    tp = tpol.policy_from_numpy(arrays, act="relu", device="cpu")
    cols = (perm_mb[:, None] * bs + np.arange(bs)).reshape(-1)
    adv_mb = torch.from_numpy(advret[0, cols])
    got = tl.ppo_grad_step_gather2(torch.from_numpy(main), torch.from_numpy(advret),
                                   *_grad_args(tp, torch.from_numpy(perm_mb), bs, adv_mb))
    jp = jpol.PolicyParams(*[jnp.asarray(a) for a in arrays], act="relu")
    ref = jl.ppo_grad_step_gather2(
        jnp.asarray(main), jnp.asarray(advret), jnp.asarray(perm_mb, jnp.int32), bs,
        jp.w1, jp.b1, jp.w2, jp.b2, jnp.concatenate([jp.w_mu, jp.w_v], axis=1),
        jnp.concatenate([jp.b_mu, jp.b_v]), jp.log_std[0],
        jnp.mean(jnp.asarray(advret[0, cols])), jnp.std(jnp.asarray(advret[0, cols])),
        act="relu", compute_dtype=jnp.float32, interpret=True,
    )
    for name in tl.PPOGradOut._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("act,logp_shift", [("relu", 0.0), ("tanh", 0.0), ("relu", -5.0)])
def test_grad_step_matches_autograd(act, logp_shift):
    """The hand-derived backward equals torch.autograd of _ppo_loss (float64).
    logp_shift=-5 pushes most ratios far above 1+eps: the clip boundary
    case, where rows whose clipped branch wins give no policy gradient."""
    rng = np.random.default_rng(3)
    N, bs, H = 1024, 32, 8
    main, advret = _learner_rows(rng, N, np.float64, logp_shift)
    arrays = _policy(4, H, act, np.float64)
    p = tpol.policy_from_numpy(arrays, act=act, dtype=torch.float64, device="cpu")
    perm_mb = torch.from_numpy(rng.permutation(N // bs)[:16])
    main_t, advret_t = torch.from_numpy(main), torch.from_numpy(advret)
    cols = (perm_mb[:, None] * bs + torch.arange(bs)).reshape(-1)
    mb = len(cols)
    out = tl.ppo_grad_step_gather2(main_t, advret_t, *_grad_args(p, perm_mb, bs, advret_t[0, cols]),
                                   act=act)
    leaves = [x.clone().requires_grad_(True) for x in p.leaves()]
    q = p.replace(**dict(zip(tpol.LEAVES, leaves)))
    cfg = tppo.PPOConfig()
    batch = (main_t[0:7, cols].T, main_t[8, cols], main_t[9, cols], advret_t[0, cols],
             advret_t[1, cols])
    loss, (pg, vl, ent) = tppo._ppo_loss(cfg, q, batch)
    loss.backward()
    grads, aux = tppo._gradout_to_grads(cfg, p, out, mb)
    want = torch.cat([x.grad.reshape(-1) for x in leaves])
    torch.testing.assert_close(grads, want, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(aux[0], pg.detach(), rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(aux[1], vl.detach(), rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(aux[2], ent.detach(), rtol=1e-12, atol=0)
    if logp_shift:
        # the case really sits past the clip boundary on most rows
        mu, log_std, _ = tpol.policy_apply(p, batch[0])
        ratio = torch.exp(tpol.gaussian_logprob(mu, log_std, batch[1]) - batch[2])
        assert (ratio > 1 + cfg.clip_eps).double().mean() > 0.5


def test_optimizer_matches_optax():
    """Seven steps of the flat clip + Adam against optax.flatten(chain(
    clip_by_global_norm, adam)), gradients of norm 0.1 to 3 (the clip at
    0.5 is active on most steps, not all); then an optax state carried
    across by opt_state_from_optax continues identically."""
    cfg = tppo.PPOConfig()
    arrays = _policy(5, 16, "relu")
    jp = jpol.PolicyParams(*[jnp.asarray(a) for a in arrays], act="relu")
    tp = tpol.policy_from_numpy(arrays, act="relu", device="cpu")
    jopt, topt = jppo.make_optimizer(cfg), tppo.make_optimizer(cfg)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    flat = tppo.flatten_params(tp)
    rng = np.random.default_rng(6)
    clipped = 0
    for step, scale in enumerate((0.1, 3.0, 1.0, 0.05, 2.0, 0.7, 0.2)):
        g = [rng.normal(0, 1, a.shape).astype(np.float32) for a in arrays]
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        g = [x * np.float32(scale / norm) for x in g]
        clipped += scale >= cfg.max_grad_norm
        jg = jpol.PolicyParams(*[jnp.asarray(x) for x in g], act="relu")
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = topt.update(torch.cat([torch.from_numpy(x).reshape(-1) for x in g]), tstate)
        flat = flat + tupd
        ref = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(jp)])
        np.testing.assert_allclose(flat.numpy(), ref, rtol=1e-6, atol=1e-9, err_msg=f"step {step}")
        if step == 3:
            # carry the optax state over and continue from it
            tstate = tppo.opt_state_from_optax(jstate, device="cpu")
            assert tstate.count == 4
    assert 0 < clipped < 7
    tp2 = tppo.unflatten_params(flat, tp)
    assert tp2.w2.shape == (16, 16) and tp2.act == "relu"
    with pytest.raises(ValueError, match="one Adam state"):
        tppo.opt_state_from_optax((1, 2), device="cpu")


def test_shuffle_blocking_matches_jax():
    for cfg in (tppo.PPOConfig(), tppo.PPOConfig(shuffle_block=2048, minibatches=4),
                tppo.PPOConfig(minibatches=3, shuffle_block=64)):
        jcfg = jppo.PPOConfig(**dataclasses.asdict(cfg))
        for N in (512, 1024 * 8, 8192 * 64, 96 * 128):
            assert tppo._shuffle_blocking(cfg, N) == jppo._shuffle_blocking(jcfg, N)


def _rows12(rng, N):
    """The 12-row buffer of the same rows as _learner_rows' two buffers."""
    main, advret = _learner_rows(rng, N)
    packed = tl.pack_minibatch_rows(*(torch.from_numpy(a) for a in (
        main[0:7].T, main[8], main[9], advret[0], advret[1])))
    return main, advret, packed


@pytest.mark.parametrize("act,gather", [("relu", True), ("tanh", False)])
def test_grad_step_12_rows_matches_jax_kernel(act, gather):
    """K4's plain version against the JAX kernel (interpret mode, float32
    compute), each with the losses scaled by a global row count
    (``loss_rows``, three times the minibatch, as a data-parallel learner
    over three devices passes): the gather form over eight 64-row shuffle
    blocks, and ppo_grad_step over a whole 512-row minibatch in 128-row
    tiles."""
    rng = np.random.default_rng(7)
    N, bs, H = 2048, 64, 16
    main, advret, packed = _rows12(rng, N)
    arrays = _policy(8, H, act)
    tp = tpol.policy_from_numpy(arrays, act=act, device="cpu")
    jp = jpol.PolicyParams(*[jnp.asarray(a) for a in arrays], act=act)
    jw = (jp.w1, jp.b1, jp.w2, jp.b2, jnp.concatenate([jp.w_mu, jp.w_v], axis=1),
          jnp.concatenate([jp.b_mu, jp.b_v]), jp.log_std[0])
    tw = (tp.w1, tp.b1, tp.w2, tp.b2, torch.cat([tp.w_mu, tp.w_v], dim=1),
          torch.cat([tp.b_mu, tp.b_v]), tp.log_std[0])
    if gather:
        perm_mb = rng.permutation(N // bs)[:8]
        cols = (perm_mb[:, None] * bs + np.arange(bs)).reshape(-1)
    else:
        cols = np.arange(512)
    adv = advret[0, cols]
    stats = (float(np.mean(adv)), float(np.std(adv)))
    loss_rows = 3 * len(cols)
    if gather:
        got = tl.ppo_grad_step_gather(packed, torch.from_numpy(perm_mb), bs, *tw, *stats, act=act,
                                      loss_rows=loss_rows)
        ref = jl.ppo_grad_step_gather(jnp.asarray(packed.numpy()), jnp.asarray(perm_mb, jnp.int32),
                                      bs, *jw, *stats, act=act, compute_dtype=jnp.float32,
                                      interpret=True, loss_rows=loss_rows)
    else:
        data = packed[:, :512].contiguous()
        got = tl.ppo_grad_step(data, *tw, *stats, act=act, row_tile=128, loss_rows=loss_rows)
        ref = jl.ppo_grad_step(jnp.asarray(data.numpy()), *jw, *stats, act=act, row_tile=128,
                               compute_dtype=jnp.float32, interpret=True, loss_rows=loss_rows)
    for name in tl.PPOGradOut._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


def test_grad_step_12_rows_equals_two_buffer_step():
    """pack_minibatch_rows lays the rows out as the JAX package does, and
    K4 over the 12-row buffer equals K3 over the two buffers of the same
    rows, bit for bit, at float32 and at bfloat16 compute; the losses' 1/n
    follows loss_rows; a compute dtype other than those two raises."""
    rng = np.random.default_rng(9)
    N, bs = 1024, 32
    main, advret, packed = _rows12(rng, N)
    ref = jl.pack_minibatch_rows(*(jnp.asarray(a) for a in (
        main[0:7].T, main[8], main[9], advret[0], advret[1])))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    tp = tpol.policy_from_numpy(_policy(10, 16, "relu"), act="relu", device="cpu")
    perm_mb = torch.from_numpy(rng.permutation(N // bs)[:8])
    cols = (perm_mb[:, None] * bs + torch.arange(bs)).reshape(-1)
    args = _grad_args(tp, perm_mb, bs, torch.from_numpy(advret[0])[cols])
    k4 = tl.ppo_grad_step_gather(packed, *args)
    k3 = tl.ppo_grad_step_gather2(torch.from_numpy(main), torch.from_numpy(advret), *args)
    for name in tl.PPOGradOut._fields:
        assert torch.equal(getattr(k4, name), getattr(k3, name)), name
    half = tl.ppo_grad_step_gather(packed, *args, loss_rows=2 * len(cols))
    torch.testing.assert_close(half.dw2, k4.dw2 / 2, rtol=1e-6, atol=1e-9)
    k4b = tl.ppo_grad_step_gather(packed, *args, compute_dtype=torch.bfloat16)
    k3b = tl.ppo_grad_step_gather2(torch.from_numpy(main), torch.from_numpy(advret), *args,
                                   compute_dtype=torch.bfloat16)
    for name in tl.PPOGradOut._fields:
        assert torch.equal(getattr(k4b, name), getattr(k3b, name)), name
    assert not torch.equal(k4b.dw2, k4.dw2)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tl.ppo_grad_step_gather(packed, *args, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match=r"\[12, N\]"):
        tl.ppo_grad_step_gather(torch.from_numpy(main), *args)
