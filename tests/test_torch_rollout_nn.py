"""Port rollout K1b (the 'nn' controller, plain PyTorch version) vs the JAX
kernel in interpret mode, and its own laws.

Against JAX: deterministic, a static meal schedule, B=128, T=4, H=8, the
JAX kernel at block_rows=1, t_chunk=2 (so its chunk carry is exercised), in
emit mode (learner rows) and plane mode (observation planes), with the
sigmoid decoder (plain and basal-scaled) and the residual-BB decoder.
Tolerances: BG/CGM rtol 2e-6 and CHO exact, as for K1a; insulin within one
pump increment plus rtol 1e-6 (the MLP's sums run in another order, and a
command within an ulp of a rounding boundary quantizes one increment
apart: 4 of 512 doses in the residual-BB case); features
atol 5e-5 (the trend feature is a difference of two CGMs that agree to
~2e-6 relative); value/raw/log-prob and the tail rtol 1e-4 with an
absolute floor of 1e-4 (those errors pass through the MLP).

Laws of the port's own stream: the sampled actions are one standard normal
per patient-step (mean 0, variance 1, no correlation between steps); a
horizon cut into two calls equals one call; an auto-reset zeroes the next
observation's insulin, meal, trend and IOB features."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.models.uva_padova import basal_rate as jax_basal_rate
from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu.params import load_quest_params
from simglucose_tpu.rl.policy import PolicyParams as JPolicy
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import policy as tpol

torch.set_num_threads(1)

B, T, H = 128, 4, 8
MEALS = dict(det_meal_times=(3, 10), det_meal_amounts=(30.0, 25.0))
INC = 0.05 / 6000.0  # one Insulet basal increment, U/min
FEAT_TOL = dict(rtol=0, atol=5e-5)
NN_TOL = dict(rtol=1e-4, atol=1e-4)


def _policy_arrays(seed, mu_bias):
    rng = np.random.default_rng(seed)
    shapes = dict(w1=(7, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,),
                  log_std=(1,), w_v=(H, 1), b_v=(1,))
    arrs = {k: rng.normal(0, np.sqrt(2.0 / s[0]), s).astype(np.float32) for k, s in shapes.items()}
    arrs["b_mu"][:] = mu_bias
    arrs["log_std"][:] = -0.5
    return list(arrs.values())


@pytest.fixture(scope="module")
def cohort():
    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    quest = load_quest_params(names, dtype=np.float32)
    packed_j = jpr.pack_params(params.patient, jax_basal_rate(params.patient), quest=quest)
    patient = from_jax(params.patient, device="cpu")
    packed_t = tr.pack_params(patient, basal_rate(patient), quest=from_jax(quest, device="cpu"))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    return packed_j, packed_t


CASES = {
    # (emit, decoder, action_scale, scale_by_basal, mu bias)
    "emit_sigmoid_basal_scaled": (True, "sigmoid", 10.0, True, -1.0),
    "planes_residual_bb": (False, "residual_bb", 1.1, False, 0.3),
    "planes_sigmoid": (False, "sigmoid", 0.2, False, -1.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nn_rollout_matches_jax_kernel(cohort, case):
    emit, decoder, scale, by_basal, bias = CASES[case]
    packed_j, packed_t = cohort
    arrays = _policy_arrays(7, bias)
    meta = dict(act="relu", action_scale=scale, scale_by_basal=by_basal, decoder=decoder)
    jp = JPolicy(*[jnp.asarray(a) for a in arrays], **meta)
    tp = tpol.policy_from_numpy(arrays, **meta, device="cpu")
    nn = dict(controller="nn", nn_hidden=H, nn_action_scale=scale, nn_scale_by_basal=by_basal,
              nn_decoder=decoder, nn_emit_learner_rows=emit, deterministic=True, n_steps=T, **MEALS)
    jcfg = jpr.PallasRolloutConfig(block_rows=1, t_chunk=2, persistent_state=True, **nn)
    ref = jpr.make_pallas_rollout(jcfg, B, interpret=True)(packed_j, 0, weights=jpr.pack_policy_weights(jp))
    got = tr.rollout(tr.RolloutConfig(**nn), packed_t, 0, weights=tr.pack_policy_weights(tp))

    for k in ("BG", "CGM"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-6, err_msg=k)
    np.testing.assert_array_equal(got["CHO"].numpy(), np.asarray(ref["CHO"]))
    assert got["CHO"].max() > 0, "meals must fire"
    np.testing.assert_allclose(got["insulin"].numpy(), np.asarray(ref["insulin"]), rtol=1e-6,
                               atol=1.001 * INC)
    assert got["insulin"].max() > got["insulin"].min(), "the policy must act"
    if emit:
        lg, lr = got["learner"].numpy(), np.asarray(ref["learner"])
        assert lg.shape == lr.shape == (10, T * B)
        np.testing.assert_allclose(lg[0:7], lr[0:7], err_msg="features", **FEAT_TOL)
        np.testing.assert_allclose(lg[7:10], lr[7:10], err_msg="value/raw/logp", **NN_TOL)
        np.testing.assert_allclose(got["tail_value"].numpy(), np.asarray(ref["tail_value"]),
                                   **NN_TOL)
        assert got["value"].data_ptr() == got["learner"][7].data_ptr()  # a view, no copy
    else:
        np.testing.assert_allclose(got["raw"].numpy(), np.asarray(ref["raw"]), **NN_TOL)
        for k in ("octrl", "oprev", "tail_octrl", "tail_oprev"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-6, err_msg=k)
        for k in ("ocho", "tail_ocho"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        for k in ("oins", "oiob", "tail_oins", "tail_oiob"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                       atol=1.001 * INC * 3 * T, err_msg=k)
    # the carried observation memory: ins_prev, ctrl_pprev, iob planes
    sf_t = got["state_f"].numpy().reshape(tr.NS_F, B)
    sf_j = np.asarray(ref["state_f"]).reshape(tr.NS_F, B)
    np.testing.assert_allclose(sf_t[62], sf_j[62], rtol=2e-6)
    np.testing.assert_allclose(sf_t[[61, 63]], sf_j[[61, 63]], rtol=0, atol=1.001 * INC * 3 * T)


def _stoch_policy(packed):
    g = torch.Generator().manual_seed(3)
    return tpol.init_policy(g, hidden=H, act="relu", init_mu_bias=-2.0, init_log_std=-0.5, device="cpu")


def test_sampled_actions_are_one_standard_normal_per_step(cohort):
    """Plane mode: z = (raw - mu)/sigma, with mu recomputed from the
    observation planes by the port's policy functions, has mean 0 and
    variance 1, and no correlation between consecutive steps (a fresh draw
    per step); emit mode's log-prob row gives the same z^2 on the same
    stream.  2048 x 12 draws: bounds at ~5 standard errors."""
    _, packed = cohort
    packed = packed.repeat(1, 16, 1)  # B = 2048
    pol = _stoch_policy(packed)
    w = tr.pack_policy_weights(pol)
    cfg = dict(controller="nn", nn_hidden=H, n_steps=12, fixed_start_min=360)
    planes = tr.rollout(tr.RolloutConfig(**cfg), packed, (5, 9), weights=w)
    emitted = tr.rollout(tr.RolloutConfig(nn_emit_learner_rows=True, **cfg), packed, (5, 9),
                         weights=w)
    basal = tr.packed_basal(packed)
    obs = tpol.featurize_parts(planes["octrl"], planes["oins"], planes["ocho"], planes["oprev"],
                               planes["oiob"], basal)
    mu, log_std, _ = tpol.policy_apply(pol, obs)
    z = (planes["raw"] - mu) / torch.exp(log_std)
    n = z.numel()
    assert abs(z.mean().item()) < 5 / n ** 0.5
    assert abs(z.var().item() - 1.0) < 5 * (2 / n) ** 0.5
    corr = torch.corrcoef(torch.stack([z[:-1].reshape(-1), z[1:].reshape(-1)]))[0, 1].item()
    assert abs(corr) < 5 / n ** 0.5
    # the same draws in emit mode: z^2 from the behaviour log-prob (row 9)
    lp = emitted["learner"][9].reshape(12, -1)
    z2 = -2.0 * (lp + log_std + 0.5 * tr.LOG_2PI)
    torch.testing.assert_close(z2, z * z, rtol=0, atol=2e-4)
    torch.testing.assert_close(emitted["learner"][8].reshape(12, -1), planes["raw"], rtol=0, atol=0)
    assert torch.equal(emitted["BG"], planes["BG"])


def test_two_calls_equal_one_and_resets_clear_the_observation(cohort):
    """Emit mode, auto-reset with a low done threshold: a horizon cut into
    two calls threading the state equals one call bit for bit (learner
    rows included); after a reset the next observation carries no insulin,
    meal, trend or IOB."""
    _, packed = cohort
    pol = _stoch_policy(packed)
    w = tr.pack_policy_weights(pol)
    kw = dict(controller="nn", nn_hidden=H, nn_emit_learner_rows=True, bg_done_high=160.0,
              fixed_start_min=420)
    one = tr.rollout(tr.RolloutConfig(n_steps=16, **kw), packed, (2, 4), weights=w)
    a = tr.rollout(tr.RolloutConfig(n_steps=8, **kw), packed, (2, 4), weights=w)
    b = tr.rollout(tr.RolloutConfig(n_steps=8, **kw), packed, (2, 4), weights=w,
                   state=(a["state_f"], a["state_i"]), init=0, step_offset=8)
    for k in ("BG", "CGM", "insulin", "reward", "done"):
        assert torch.equal(torch.cat([a[k], b[k]]), one[k]), k
    lrn = one["learner"].reshape(10, 16, B)
    assert torch.equal(torch.cat([a["learner"].reshape(10, 8, B), b["learner"].reshape(10, 8, B)],
                                 dim=1), lrn)
    assert torch.equal(b["tail_value"], one["tail_value"])
    assert torch.equal(b["state_f"], one["state_f"])
    done = one["done"][:-1]
    assert done.sum() >= 3, "the threshold must cause resets"
    nxt = lrn[:, 1:][:, done]  # features of the step after each reset
    for k in (2, 3, 4, 5):
        assert (nxt[k] == 0).all(), f"feature {k} after a reset"
    assert (lrn[2, 1:][~done] != 0).any()


def test_nn_config_checks(cohort):
    _, packed = cohort
    w = tr.pack_policy_weights(_stoch_policy(packed))
    nn = dict(controller="nn", nn_hidden=H, n_steps=2)
    with pytest.raises(ValueError, match="needs weights"):
        tr.rollout(tr.RolloutConfig(**nn), packed)
    with pytest.raises(ValueError, match=r"\[8, 24\]"):
        tr.rollout(tr.RolloutConfig(**nn), packed, weights=w[:, :20])
    with pytest.raises(ValueError, match="multiple of 8"):
        tr.rollout(tr.RolloutConfig(**{**nn, "nn_hidden": 12}), packed, weights=w)
    with pytest.raises(ValueError, match="nn_decoder"):
        tr.rollout(tr.RolloutConfig(nn_decoder="bolus", **nn), packed, weights=w)
    with pytest.raises(ValueError, match="requires controller='nn'"):
        tr.rollout(tr.RolloutConfig(n_steps=2, nn_emit_learner_rows=True), packed)
    with pytest.raises(ValueError, match="requires mean actions"):
        tr.rollout(tr.RolloutConfig(exogenous_noise=True, autoreset=False, **nn), packed,
                   weights=w, reset_noise=torch.zeros(2, 1, 128), step_noise=torch.zeros(2, 1, 128))
