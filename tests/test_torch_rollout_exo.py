"""Port rollout K1a (plain PyTorch version) with caller-supplied CGM noise:
the exogenous-noise BB config against the JAX kernel itself in interpret
mode, and the static-scenario stochastic code path against the JAX env
path, both with the reference's MT19937 noise stream; plus the Quest
sentinel.

Tolerances are the JAX kernel's own (tests/test_pallas_rollout.py): BG/CGM
rtol 2e-6, insulin rtol 1e-6, CHO exact, reward atol 1e-4; both sides
float32.  One exception is stated in :func:`_assert_insulin`: XLA and
PyTorch round transcendentals differently, so CGM agrees to an ulp, and a
bolus command that lies within that ulp of a pump rounding boundary
quantizes one increment apart."""
import jax
import numpy as np
import torch

from simglucose_tpu.compat.noise import reference_cgm_noise
from simglucose_tpu.controllers.functional import bb_params, bb_policy
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import batch_reset, make_batch_continue_fn
from simglucose_tpu.models.uva_padova import basal_rate as jax_basal_rate
from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu.params import load_quest_params, sensor_record
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr

torch.set_num_threads(1)

B = 128
T = 8
MEAL_TIMES = (3, 10)
MEAL_AMOUNTS = (30.0, 25.0)


def _inputs(quest=True):
    names = cohort_names(B)
    q = load_quest_params(names, dtype=np.float32) if quest else None
    _, params = make_env(names, batch=True, dtype=np.float32)
    patient = from_jax(params.patient, device="cpu")
    packed_t = tr.pack_params(patient, basal_rate(patient), quest=None if q is None else from_jax(q, device="cpu"))
    packed_j = jpr.pack_params(params.patient, jax_basal_rate(params.patient), quest=q)
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(np.float32)
    bc = lambda a: np.ascontiguousarray(np.broadcast_to(a[:, None, None], (len(a), 1, 128)))
    return names, q, params, packed_j, packed_t, noise, bc(noise[:2]), bc(noise[2:])


def _assert_insulin(got, ref, inc=0.05):
    """Insulin rtol 1e-6, except on at most 1% of the entries, which may sit
    exactly one pump increment (inc / 6000 U/min) apart: a quantization
    flip, not drift."""
    got, ref = got.numpy(), np.asarray(ref)
    off = ~np.isclose(got, ref, rtol=1e-6, atol=0.0)
    assert off.mean() <= 0.01, off.mean()
    if off.any():
        # the difference of two float32 doses carries their rounding: 2 ulps
        ulp = np.spacing(np.abs(ref[off]).max())
        np.testing.assert_allclose(np.abs(got - ref)[off], inc / 6000.0, rtol=0, atol=2 * ulp)


def _check(got, ref):
    for k, kw in (("BG", dict(rtol=2e-6)), ("CGM", dict(rtol=2e-6)), ("reward", dict(atol=1e-4))):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **kw)
    _assert_insulin(got["insulin"], ref["insulin"])
    np.testing.assert_array_equal(got["CHO"].numpy(), np.asarray(ref["CHO"]))


def test_exogenous_noise_bb_matches_jax_kernel():
    """Nonzero reference noise + static meals + BB, against the JAX kernel
    in interpret mode: every trajectory plane and the reset CGM (which takes
    the first of the two reset noise pops)."""
    _, _, _, packed_j, packed_t, noise, rnoise, snoise = _inputs()
    common = dict(n_steps=T, deterministic=True, exogenous_noise=True, autoreset=False,
                  controller="bb", det_meal_times=MEAL_TIMES, det_meal_amounts=MEAL_AMOUNTS)
    jcfg = jpr.PallasRolloutConfig(block_rows=1, t_chunk=2, **common)
    ref = jpr.make_pallas_rollout(jcfg, B, interpret=True)(packed_j, 0, rnoise, snoise)
    got = tr.rollout(tr.RolloutConfig(**common), packed_t, 0,
                     reset_noise=torch.from_numpy(rnoise), step_noise=torch.from_numpy(snoise))
    assert abs(noise[0]) > 1.0
    _check(got, ref)
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(ref["done"]))
    np.testing.assert_allclose(got["CGM0"].numpy(), np.asarray(ref["CGM0"]), rtol=1e-6)
    np.testing.assert_allclose(got["BG0"].numpy(), np.asarray(ref["BG0"]), rtol=1e-7)


def test_static_scenario_stochastic_path_matches_env():
    """scenario_kind='static' on the stochastic code path (fixed start,
    x0 init, exogenous noise) against the JAX env path: the contract behind
    simulate() with a custom scenario."""
    names, q, params, _, packed_t, noise, rnoise, snoise = _inputs()
    cfg = tr.RolloutConfig(
        n_steps=T, deterministic=False, scenario_kind="static", exogenous_noise=True,
        autoreset=False, random_init_bg=False, fixed_start_min=0, controller="bb",
        det_meal_times=MEAL_TIMES, det_meal_amounts=MEAL_AMOUNTS,
    )
    got = tr.rollout(cfg, packed_t, 5, reset_noise=torch.from_numpy(rnoise),
                     step_noise=torch.from_numpy(snoise))
    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(MEAL_TIMES, MEAL_AMOUNTS):
        meal_seq[t] = a
    ecfg, eparams = make_env(names, batch=True, dtype=np.float32, scenario_mode="exogenous",
                             meal_seq=meal_seq, noise_seq=noise, substeps=1, method="rk4")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(ecfg, eparams, keys, start_min=0)
    _, _, _, traj = make_batch_continue_fn(ecfg, bb_policy(3), T)(
        eparams, state, bb_params(params.patient, q), res)
    _check(got, traj._asdict())
    np.testing.assert_allclose(got["CGM0"].numpy(), np.asarray(res.CGM), rtol=1e-6)


def test_bb_without_quest_goes_nan():
    """Without Quest the CR/CF planes hold the finite -1.0 sentinel (the
    packed planes stay NaN-free); a BB config reads it as NaN, so the first
    bolus poisons the insulin plane instead of dosing with made-up ratios."""
    _, _, _, packed_j, packed_t, *_ = _inputs(quest=False)
    assert torch.isfinite(packed_t).all()
    cfg = tr.RolloutConfig(n_steps=2, deterministic=True, controller="bb",
                           det_meal_times=(0,), det_meal_amounts=(30.0,))
    ins = tr.rollout(cfg, packed_t, 0)["insulin"]
    assert torch.isfinite(ins[0]).all()
    assert torch.isnan(ins[1]).all()
