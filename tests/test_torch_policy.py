"""Port policy (rl/policy.py) vs the JAX package: the features, the MLP, the
Gaussian log-prob and the IOB update on the same seeded inputs, at float64
and float32; the shipped checkpoints read without JAX; the kernel's packed
weight layout.

Tolerances: the features and IOB at float64 rtol 1e-12 (both sides do the
same operations; only libm's and XLA's tanh differ in the last bits), at
float32 rtol 2e-6.  The MLP outputs and log-probs rtol 2e-6 with an
absolute floor of 1e-6 at both dtypes: XLA's and PyTorch's CPU matmuls sum
in other orders, and the JAX policy_apply accumulates its dots in float32
(preferred_element_type) even on float64 inputs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu.rl import policy as jpol
from simglucose_tpu.utils.checkpoint import restore_state
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import policy as tpol

torch.set_num_threads(1)

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "checkpoints")
# the decoders the shipped checkpoints were trained with (tests/test_ppo_eval.py)
CHECKPOINTS = {
    "ppo_cohort_relu64.npz": dict(act="relu", action_scale=10.0, scale_by_basal=True),
    "ppo_cohort_residual_bb.npz": dict(act="relu", action_scale=1.1, scale_by_basal=False,
                                       decoder="residual_bb"),
}
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-6, atol=1e-6)}
MLP_TOL = dict(rtol=2e-6, atol=1e-6)


def _arrays(seed, H, dtype):
    rng = np.random.default_rng(seed)
    shapes = dict(w1=(7, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,),
                  log_std=(1,), w_v=(H, 1), b_v=(1,))
    return [(rng.normal(0, 0.5, s)).astype(dtype) for s in shapes.values()]


def _pair(arrays, **meta):
    j = jpol.PolicyParams(*[jnp.asarray(a) for a in arrays], **meta)
    t = tpol.policy_from_numpy(arrays, dtype=torch.from_numpy(arrays[0]).dtype, **meta, device="cpu")
    return j, t


def _obs_inputs(rng, n, dtype):
    return [
        rng.uniform(40, 400, n).astype(dtype),  # cgm
        rng.uniform(0, 0.5, n).astype(dtype),  # insulin
        rng.uniform(0, 20, n).astype(dtype) * (rng.uniform(size=n) < 0.3),  # cho
        rng.uniform(40, 400, n).astype(dtype),  # cgm_prev
        rng.uniform(0, 5, n).astype(dtype),  # iob
        rng.uniform(0.005, 0.06, n).astype(dtype),  # basal
    ]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_featurize_and_iob_match_jax(dtype):
    rng = np.random.default_rng(1)
    ins = _obs_inputs(rng, 512, dtype)
    got = tpol.featurize_parts(*[torch.from_numpy(a) for a in ins]).numpy()
    ref = np.asarray(jpol.featurize_parts(*[jnp.asarray(a) for a in ins]))
    assert got.shape == ref.shape == (512, 7) and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype]["rtol"], atol=0)
    iob, dose = ins[4], ins[1]
    for st in (1, 3, 5):
        np.testing.assert_allclose(
            tpol.iob_step(torch.from_numpy(iob), torch.from_numpy(dose), st).numpy(),
            np.asarray(jpol.iob_step(jnp.asarray(iob), jnp.asarray(dose), st)),
            rtol=TOL[dtype]["rtol"], atol=0,
        )


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_policy_apply_and_logprob_match_jax(act, dtype):
    jp, tp = _pair(_arrays(2, 16, dtype), act=act)
    rng = np.random.default_rng(3)
    obs = rng.normal(0, 1, (4, 32, 7)).astype(dtype)
    x = rng.normal(-1, 1, (4, 32)).astype(dtype)
    mu, ls, v = tpol.policy_apply(tp, torch.from_numpy(obs))
    jmu, jls, jv = jpol.policy_apply(jp, jnp.asarray(obs))
    for got, ref in ((mu, jmu), (ls, jls), (v, jv)):
        assert got.dtype == torch.from_numpy(np.array(ref)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MLP_TOL)
    lp = tpol.gaussian_logprob(mu, ls, torch.from_numpy(x))
    jlp = jpol.gaussian_logprob(jmu, jls, jnp.asarray(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **MLP_TOL)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_load_policy_npz_matches_restore_state(name):
    """Both shipped checkpoints: the JAX-free loader gives the leaves JAX's
    restore_state gives, bit for bit, and the metadata asked for."""
    meta = CHECKPOINTS[name]
    path = os.path.join(CKPT_DIR, name)
    like = jpol.init_policy(jax.random.PRNGKey(0), hidden=64, **meta)
    ref = restore_state(path, like=like)
    got = tpol.load_policy_npz(path, **meta, device="cpu")
    for n, g in zip(tpol.LEAVES, got.leaves()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(ref, n)), err_msg=n)
        assert g.dtype == torch.float32
    for k, v in meta.items():
        assert getattr(got, k) == v
    # the weights pack into the kernel's layout exactly as JAX packs them
    np.testing.assert_array_equal(tr.pack_policy_weights(got).numpy(),
                                  np.asarray(jpr.pack_policy_weights(ref)))


def test_pack_policy_weights_layout_and_checks():
    arrays = _arrays(4, 8, np.float32)
    jp, tp = _pair(arrays, act="relu")
    np.testing.assert_array_equal(tr.pack_policy_weights(tp).numpy(),
                                  np.asarray(jpr.pack_policy_weights(jp)))
    with pytest.raises(ValueError, match="relu trunk"):
        tr.pack_policy_weights(tp.replace(act="tanh"))
    with pytest.raises(ValueError, match="leaf w2"):
        tpol.policy_from_numpy(arrays[:2] + [arrays[2][:4]] + arrays[3:], device="cpu")
    with pytest.raises(ValueError, match="expected 9 arrays"):
        tpol.policy_from_numpy(arrays[:8], device="cpu")


def test_init_policy_and_decoder_checks():
    g = torch.Generator().manual_seed(0)
    p = tpol.init_policy(g, hidden=16, act="relu", init_mu_bias=-2.2, init_log_std=-0.5, device="cpu")
    assert p.w1.shape == (7, 16) and p.w2.shape == (16, 16) and p.w_mu.shape == (16, 1)
    assert float(p.b_mu[0]) == pytest.approx(-2.2) and float(p.log_std[0]) == -0.5
    assert float(p.b1.abs().sum()) == 0.0 and float(p.w1.std()) > 0.1
    # same generator state, same weights
    q = tpol.init_policy(torch.Generator().manual_seed(0), hidden=16, act="relu",
                         init_mu_bias=-2.2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.leaves(), q.leaves()))
    with pytest.raises(ValueError, match="act must be"):
        tpol.init_policy(g, act="gelu", device="cpu")
    with pytest.raises(ValueError, match="decoder must be"):
        tpol.init_policy(g, decoder="bolus", device="cpu")
    tpol.check_action_decoder(p, 0.2, False, "here")
    with pytest.raises(ValueError, match="action decoder mismatch"):
        tpol.check_action_decoder(p, 10.0, True, "here")
