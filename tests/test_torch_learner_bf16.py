"""The bfloat16 learner (``PPOConfig.learner_bf16``): the port's bf16
compute dtype of the grad-step kernels K3, K4 and K5, of ``policy_apply``
and of the autograd learner, against the JAX package's, and the kernels'
block routine built for the host against the plain bf16 versions.

bfloat16 here is the JAX package's: both operands of a product rounded to
bfloat16 (round to nearest even), the products accumulated in float32.  The
plain versions compute it as float32 matmuls of rounded operands; the
kernels run their three H x H products on the tensor cores (mma.sync
m16n8k16 tiles of bfloat16 operands with float32 sums, which a host build
emulates lane by lane: tests/test_torch_mma_tile.py) and the smaller ones
as float32 FMAs of rounded operands.  Every product of two bfloat16 values
is exact in float32, so the two differ only in the order of the sums and
every comparison holds to float32 tolerances, far inside the gap between
the bf16 and the f32 results (each test also checks that gap):

* the rounding helper of ``csrc/ppo_math.cuh`` (host build) against
  ``torch.Tensor.to(torch.bfloat16)``, bit for bit on edge values (ties,
  subnormals, inf, finite values that round to inf, random bits); NaN
  stays NaN;
* the host-built bf16 block routine (H = 16, 18, 64, 100, 128: the tensor
  cores' tiles padded with zeros past a ragged H) against the plain bf16
  grad step, and the plain bf16 ``tile_grads`` and K4 against JAX's
  ``_tile_grads(cd=bfloat16)`` and its K4 kernel in interpret mode: each
  gradient leaf and loss sum within TOL_BF16 = 2e-4 of its largest
  magnitude.  Summed in another order, an operand may come out an ulp apart
  and round to the other bfloat16 neighbour, which moves its products by
  2^-8 of them: measured up to 5.9e-5 with tanh at H = 64 and 128 over 1536
  rows (six seeds), <= 6.7e-7 where no operand flips;
* K5's bf16 grid against the plain bf16 'step' loop with
  tests/test_torch_kernel_host.py's K5 tolerances;
* ``policy_apply(compute_dtype=bfloat16)`` against JAX: rtol 1e-5, atol
  1e-5;
* the autograd learner with ``learner_bf16`` against JAX's ``_update``
  under the same config: tests/test_torch_plane.py's learner tolerances.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.ops import pallas_ppo_learner as jl
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.rl import ppo as jppo
from simglucose_tpu_torch.ops import ppo_learner as lrn
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo

from test_torch_kernel_host import _check_whole_learner, _rows12, host_lib  # noqa: F401
from test_torch_plane import TOL_AUX, TOL_NU, TOL_PARAMS, _transition

torch.set_num_threads(1)

BF16 = torch.bfloat16
TOL_BF16 = 2e-4


def _max_rel(got, ref):
    """Each PPOGradOut leaf's max abs error over its largest magnitude."""
    return {f: float((getattr(got, f) - getattr(ref, f)).abs().max())
            / max(float(getattr(ref, f).abs().max()), 1e-30) for f in lrn.PPOGradOut._fields}


# ---------------------------------------------------------------------------
# The rounding helper and the host-built block routine
# ---------------------------------------------------------------------------


def test_bf16_round_is_torchs_rounding(host_lib):
    """Ties to even either way, subnormals, the largest bfloat16 and values
    at and past halfway above it (to inf), infinities, NaN, and random bit
    patterns (every class of float32)."""
    edge = [0.0, -0.0, 1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9,
            -(1.0 + 2 ** -9), 3.3895314e38, 3.3961776e38, 3.4e38, float("inf"), float("-inf"),
            float("nan"), 1e-40, -1e-40, 1e-45, 9.1835e-41, 1.1754942e-38, 1.1754944e-38]
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = torch.cat([torch.tensor(edge, dtype=torch.float32),
                   torch.from_numpy(rng.normal(0, 3, 2000).astype(np.float32)),
                   torch.from_numpy(bits.copy())])
    out = torch.full_like(x, 7.0)
    host_lib.host_bf16_round(x.data_ptr(), out.data_ptr(), x.numel())
    ref = x.to(BF16).to(torch.float32)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan) and int(nan.sum()) > 10
    assert torch.equal(out[~nan].view(torch.int32), ref[~nan].view(torch.int32))
    assert out[8] == x[8] and out[9] == float("inf") and out[10] == float("inf")


def _host_act(host_lib, act, x):
    """The host build's activation ``act`` of float32 ``x``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    host_lib.host_act(act, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def _grad_case(Hg, seed, N=1536, bs=48):
    rng = np.random.default_rng(seed)
    packed = _rows12(rng, N)
    w = [torch.from_numpy(rng.normal(0, 0.4 * (16 / Hg) ** 0.5, s).astype(np.float32))
         for s in ((7, Hg), (Hg,), (Hg, Hg), (Hg,), (Hg, 2), (2,))]
    perm_mb = torch.from_numpy(rng.permutation(N // bs)[:8])
    cols = (perm_mb[:, None] * bs + torch.arange(bs)).reshape(-1)
    adv = packed[10, cols]
    return packed, (perm_mb, bs, *w, torch.tensor(-0.5), adv.mean(), adv.std(correction=0))


@pytest.mark.parametrize("Hg", [16, 18, 64, 100, 128])
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("split", [1, 2])
def test_host_built_bf16_grad_step_matches_plain_version(host_lib, monkeypatch, Hg, act, split):
    """K4's bf16 instantiation, one thread per block over the kernel's
    shared-memory layout (48-row shuffle blocks: a partial tile at every
    width; H = 18 and 100 pad the tensor-core tiles), against the plain
    bf16 grad step; and K3's on the two buffers of the same rows.  The
    plain version's tanh is the host build's (libm's tanhf): torch.tanh
    rounds about half of the h1 values an ulp apart from it, and one of
    them that lies at a bfloat16 halfway point rounds the operand to the
    other neighbour for all H of its row's products (at H = 100, tanh,
    split 1: row 39's mu moves by 1.6e-3, db1 by 4.4e-4 of its largest
    magnitude, with or without the tensor-core tile).  What is left is the
    order of the sums, which TOL_BF16 bounds."""
    monkeypatch.setattr(torch, "tanh", functools.partial(_host_act, host_lib, 1))
    packed, args = _grad_case(Hg, Hg + split)
    kw = dict(act=act, clip_eps=0.2, vf_coef=0.5)
    a, _keep, out, n_blk = lrn._grad_step_args(packed, None, *args, *kw.values(), split=split,
                                               compute_dtype=BF16)
    assert a.bf16 == 1
    host_lib.host_ppo_grad12(ctypes.addressof(a), n_blk, out.data_ptr())
    got = lrn._grad_out(out, Hg)
    ref = lrn.ppo_grad_step_gather_reference(packed, *args, compute_dtype=BF16, **kw)
    f32 = lrn.ppo_grad_step_gather_reference(packed, *args, **kw)
    err = _max_rel(got, ref)
    assert max(err.values()) <= TOL_BF16, err
    assert max(_max_rel(f32, ref).values()) > 1e-3  # the bf16 result is not the f32 one

    main, advret = packed[:10].contiguous(), packed[10:12].contiguous()
    a, _keep, out, n_blk = lrn._grad_step_args(main, advret, *args, *kw.values(), split=split,
                                               compute_dtype=BF16)
    host_lib.host_ppo_grad(ctypes.addressof(a), n_blk, out.data_ptr())
    ref2 = lrn.ppo_grad_step_gather2_reference(main, advret, *args, compute_dtype=BF16, **kw)
    for f in lrn.PPOGradOut._fields:
        assert torch.equal(getattr(ref2, f), getattr(ref, f)), f
    err = _max_rel(lrn._grad_out(out, Hg), ref)
    assert max(err.values()) <= TOL_BF16, err


@pytest.mark.parametrize("Hg,act,split,max_grad_norm", [
    (16, "relu", 1, 0.5), (18, "tanh", 1, 100.0), (100, "relu", 2, 0.5), (128, "tanh", 2, 0.5)])
def test_host_built_bf16_whole_learner_matches_plain_version(host_lib, Hg, act, split,
                                                            max_grad_norm):
    """K5's bf16 instantiation as its barriers order it, over 2 epochs x 2
    minibatches from an Adam state three steps in, with the global-norm
    clip active (0.5) or not (100), against the plain bf16 'step' loop."""
    rng = np.random.default_rng(Hg)
    N, bs, bpm = 2048, 64, 8
    packed = _rows12(rng, N)
    cfg = tppo.PPOConfig(epochs=2, minibatches=2, lr=1e-3, max_grad_norm=max_grad_norm)
    opt = tppo.make_optimizer(cfg)
    shapes = ((7, Hg), (Hg,), (Hg, Hg), (Hg,), (Hg, 1), (1,), (1,), (Hg, 1), (1,))
    arrs = [rng.normal(0, 0.4 * (16 / Hg) ** 0.5, s).astype(np.float32) for s in shapes]
    arrs[6][:] = -0.5
    params = tpol.policy_from_numpy(arrs, act=act, device="cpu")
    P = tppo.flatten_params(params).numel()
    state = tppo.AdamState(3, torch.from_numpy(rng.normal(0, 1e-2, P).astype(np.float32)),
                           torch.from_numpy(rng.uniform(0, 1e-4, P).astype(np.float32)))
    perm_all = torch.cat([torch.from_numpy(rng.permutation(N // bs)[:2 * bpm]) for _ in range(2)])
    adv_b = packed[10].view(N // bs, bs)
    mean, std = tppo.minibatch_adv_stats(adv_b.sum(1), (adv_b * adv_b).sum(1),
                                         perm_all.view(-1, bpm), bpm * bs)
    e, keep = lrn._epoch_args(cfg, opt, params, state, packed, perm_all, bs, mean, std, bpm * bs,
                              split=split, compute_dtype=BF16)
    host_lib.host_ppo_epoch(ctypes.addressof(e))
    ref = lrn.ppo_epoch_update_reference(cfg, opt, params, state, packed, perm_all, bs, mean, std,
                                         compute_dtype=BF16)
    _check_whole_learner(keep, ref, params, max_grad_norm)
    f32 = lrn.ppo_epoch_update_reference(cfg, opt, params, state, packed, perm_all, bs, mean, std)
    assert not torch.equal(tppo.flatten_params(f32[0]), tppo.flatten_params(ref[0]))


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_tile_grads_bf16_matches_jax(act):
    """The plain ``tile_grads`` at bfloat16 against JAX's ``_tile_grads``
    with ``cd=bfloat16`` (pure JAX, called directly) over 256 rows, H=32."""
    rng = np.random.default_rng(3)
    R, H = 256, 32
    x = rng.normal(0, 1, (7, R)).astype(np.float32)
    raw, lpo = rng.normal(-1, 1, R).astype(np.float32), rng.normal(-1.2, 0.3, R).astype(np.float32)
    adv, ret = rng.normal(0, 1, R).astype(np.float32), rng.normal(0, 1, R).astype(np.float32)
    w1, w2 = rng.normal(0, 0.5, (7, H)).astype(np.float32), rng.normal(0, 0.3, (H, H)).astype(np.float32)
    b1, b2 = rng.normal(0, 0.1, H).astype(np.float32), rng.normal(0, 0.1, H).astype(np.float32)
    wh, bh = rng.normal(0, 0.3, (H, 2)).astype(np.float32), rng.normal(0, 0.1, 2).astype(np.float32)
    ls, mean, rstd, inv_n = -0.5, float(adv.mean()), float(1 / (adv.std() + 1e-8)), 1.0 / R
    kw = dict(act=act, clip_eps=0.2, vf_coef=0.5)
    f32 = jnp.float32
    row = lambda v: jnp.asarray(v).reshape(1, R)
    jout = jl._tile_grads(
        jnp.concatenate([jnp.asarray(x), jnp.zeros((1, R), f32)]), row(raw), row(lpo), row(adv),
        row(ret), jnp.pad(jnp.asarray(w1), ((0, 1), (0, 0))).T, jnp.asarray(b1).reshape(H, 1),
        jnp.asarray(w2).T, jnp.asarray(b2).reshape(H, 1), jnp.asarray(wh).T,
        jnp.asarray(bh).reshape(2, 1), f32(ls), f32(mean), f32(rstd), f32(inv_n),
        cd=jnp.bfloat16, **kw)
    jref = lrn.PPOGradOut(*(torch.from_numpy(np.array(a)) for a in (
        jout[0][:7], jout[1][:, 0], jout[2], jout[3][:, 0], jout[4], jout[5][:, 0], jout[6],
        jout[7], jout[8])))
    t = lambda a: torch.from_numpy(a)
    args = (t(x), t(raw), t(lpo), t(adv), t(ret), t(w1), t(b1), t(w2), t(b2), t(wh), t(bh),
            torch.tensor(ls), torch.tensor(mean), torch.tensor(rstd), torch.tensor(inv_n))
    got = lrn.tile_grads(*args, compute_dtype=BF16, **kw)
    err = _max_rel(got, jref)
    assert max(err.values()) <= TOL_BF16, err
    assert max(_max_rel(lrn.tile_grads(*args, **kw), jref).values()) > 1e-3


def test_grad_step_12_rows_bf16_matches_jax_kernel():
    """K4's plain version at bfloat16 against the JAX kernel at
    ``compute_dtype=bfloat16`` in interpret mode: two 64-row shuffle blocks
    of the 12-row buffer, H=16, relu."""
    rng = np.random.default_rng(21)
    N, bs, H = 512, 64, 16
    packed = _rows12(rng, N)
    w = [rng.normal(0, 0.4, s).astype(np.float32) for s in ((7, H), (H,), (H, H), (H,), (H, 2), (2,))]
    perm_mb = rng.permutation(N // bs)[:2]
    cols = (perm_mb[:, None] * bs + np.arange(bs)).reshape(-1)
    adv = packed[10].numpy()[cols]
    stats = (float(np.mean(adv)), float(np.std(adv)))
    got = lrn.ppo_grad_step_gather(packed, torch.from_numpy(perm_mb), bs,
                                   *(torch.from_numpy(a) for a in w), torch.tensor(-0.5), *stats,
                                   act="relu", compute_dtype=BF16)
    ref = jl.ppo_grad_step_gather(jnp.asarray(packed.numpy()), jnp.asarray(perm_mb, jnp.int32), bs,
                                  *(jnp.asarray(a) for a in w), jnp.float32(-0.5), *stats,
                                  act="relu", compute_dtype=jnp.bfloat16, interpret=True)
    jref = lrn.PPOGradOut(*(torch.from_numpy(np.array(getattr(ref, f)))
                            for f in lrn.PPOGradOut._fields))
    err = _max_rel(got, jref)
    assert max(err.values()) <= TOL_BF16, err
    f32 = lrn.ppo_grad_step_gather(packed, torch.from_numpy(perm_mb), bs,
                                   *(torch.from_numpy(a) for a in w), torch.tensor(-0.5), *stats,
                                   act="relu")
    assert max(_max_rel(f32, jref).values()) > 1e-3


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_policy_apply_bf16_matches_jax(act):
    """``policy_apply(compute_dtype=bfloat16)``: the trunk's operands and
    stored activations rounded, the heads' bias adds float32."""
    jp = jpol.init_policy(jax.random.PRNGKey(4), hidden=32, act=act, init_mu_bias=-1.0)
    tp = tpol.policy_from_numpy([np.asarray(x) for x in jax.tree.leaves(jp)], act=act,
                                device="cpu")
    obs = np.random.default_rng(5).normal(0, 1, (3, 50, 7)).astype(np.float32)
    jmu, jls, jv = jpol.policy_apply(jp, jnp.asarray(obs), compute_dtype=jnp.bfloat16)
    tmu, tls, tv = tpol.policy_apply(tp, torch.from_numpy(obs), compute_dtype=BF16)
    assert tmu.dtype == torch.float32 and tmu.shape == (3, 50)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert float(tls) == float(jls)
    f32 = tpol.policy_apply(tp, torch.from_numpy(obs))[2]
    assert float((f32 - tv).abs().max()) > 1e-3


def _update_both(learner_bf16, seed=0):
    """The port's and JAX's ``_update`` with the autograd learner
    (``pallas_learner=False``) on one transition, the same permutations and
    the same optimizer state, one Adam step in."""
    arrays = _transition(seed)
    cfg_kw = dict(epochs=2, minibatches=2, lr=1e-3, learner_bf16=learner_bf16)
    jcfg, tcfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jp = jpol.init_policy(jax.random.PRNGKey(3), hidden=16, act="relu", init_mu_bias=-1.0)
    tp = tpol.policy_from_numpy([np.asarray(x) for x in jax.tree.leaves(jp)], act="relu",
                                device="cpu")
    jopt = jppo.make_optimizer(jcfg)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32), jp)
    _, jstate = jopt.update(g, jopt.init(jp), jp)
    key = jax.random.PRNGKey(11)
    T, B = arrays[0].shape[:2]
    _, n_blocks, _ = tppo._shuffle_blocking(tcfg, T * B)
    perms, k = [], key
    for _ in range(tcfg.epochs):
        k, k_perm = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(k_perm, n_blocks)))
    obs, raw, logp, value, reward, done, advs, rets = (jnp.asarray(a) for a in arrays)
    jout = jppo._update(jcfg, jopt, jp, jstate, jppo.Transition(obs, raw, logp, value, reward,
                                                                 done), advs, rets, key, None)
    obs, raw, logp, value, reward, done, advs, rets = (torch.from_numpy(a) for a in arrays)
    tout = tppo._update(tcfg, tppo.make_optimizer(tcfg), tp,
                        tppo.opt_state_from_optax(jstate, device="cpu"),
                        tppo.Transition(obs, raw, logp, value, reward, done), advs, rets,
                        perms=perms)
    return jout, tout


def test_autograd_learner_honours_learner_bf16():
    """The port's ``_update(PPOConfig(learner_bf16=True))`` with the
    autograd learner trains bf16 and matches JAX's ``_update`` under the
    same config (params, Adam's mu and nu, the aux), and its result differs
    from the port's float32 one: before the port read ``learner_bf16`` the
    two were the same."""
    (jp2, jstate2, _, jaux), (tp2, tstate2, taux) = _update_both(True)
    for name, got in zip(tpol.LEAVES, tp2.leaves()):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jp2, name)), err_msg=name,
                                   **TOL_PARAMS)
    jadam = tppo.opt_state_from_optax(jstate2, device="cpu")
    np.testing.assert_allclose(tstate2.mu.numpy(), jadam.mu.numpy(), **TOL_PARAMS)
    np.testing.assert_allclose(tstate2.nu.numpy(), jadam.nu.numpy(), **TOL_NU)
    for got, ref in zip(taux, jaux):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_AUX)
    _, (tp32, tstate32, _) = _update_both(False)
    assert float((tstate32.mu - tstate2.mu).abs().max()) > 1e-4
    assert any(not torch.equal(a, b) for a, b in zip(tp32.leaves(), tp2.leaves()))
