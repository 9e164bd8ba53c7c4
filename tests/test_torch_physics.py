"""Port physics and risk vs the JAX package: the UVA/Padova right-hand side,
the RK4/RK45 minute, the open-loop reference goldens, and the risk index.

Inputs are made with numpy from a seed and handed to both sides in the
named dtype (the suite runs JAX with x64 on).  Tolerances: float64 rtol
1e-12 (the same operations in the same order; only libm's last bits may
differ); float32 rtol 2e-6 (XLA and PyTorch round tanh/log/pow
differently, a few ulps); the goldens at tests/test_patient.py's own
tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.analysis import risk as jrisk
from simglucose_tpu.models import uva_padova as juva
from simglucose_tpu.params import load_patient_params
from simglucose_tpu_torch.analysis import risk as trisk
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.models import uva_padova as tuva

from conftest import load_golden

torch.set_num_threads(1)

_TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-6, atol=1e-6)}


def _random_inputs(dtype, n=30, seed=0):
    """Seeded states around each patient's x0, with meals in and out of
    transit (Dbar 0 and > 0) and states straddling the ke2/zero gates."""
    rng = np.random.default_rng(seed)
    p = load_patient_params(list(range(1, n + 1)), dtype=np.float64)
    x = np.asarray(p.x0) * rng.uniform(0.5, 1.5, (n, 13))
    x[:, 0:3] = rng.uniform(0.0, 4e4, (n, 3))
    x[::7, 5] = -1e-3  # a gated state
    d_mg = rng.uniform(0.0, 5000.0, n) * (rng.random(n) < 0.5)
    ins = rng.uniform(0.0, 0.5, n)
    dbar = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(1e3, 9e4, n))
    cast = lambda a: np.asarray(a, dtype)
    params = jax.tree.map(cast, load_patient_params(list(range(1, n + 1)), dtype=np.float64))
    return params, cast(x), cast(d_mg), cast(ins), cast(dbar)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_model_rhs_parts_matches_jax(dtype):
    params, x, d_mg, ins, dbar = _random_inputs(dtype)
    ref = juva.model_rhs_parts(tuple(jnp.asarray(x[:, i]) for i in range(13)), params,
                               jnp.asarray(d_mg), jnp.asarray(ins), jnp.asarray(dbar))
    tp = from_jax(params, device="cpu")
    got = tuva.model_rhs_parts(tuple(torch.from_numpy(x[:, i]) for i in range(13)), tp,
                               torch.from_numpy(d_mg), torch.from_numpy(ins), torch.from_numpy(dbar))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"dx{i}", **_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk45", 2)])
def test_integrate_minute_matches_jax(dtype, method, substeps):
    params, x, d_mg, ins, dbar = _random_inputs(dtype, seed=1)
    ref = juva.integrate_minute(jnp.asarray(x), params, jnp.asarray(d_mg), jnp.asarray(ins),
                                jnp.asarray(dbar), substeps=substeps, method=method)
    got = tuva.integrate_minute(torch.from_numpy(x), from_jax(params, device="cpu"), torch.from_numpy(d_mg),
                                torch.from_numpy(ins), torch.from_numpy(dbar),
                                substeps=substeps, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_TOL[dtype])
    np.testing.assert_allclose(tuva.observe_gsub(got, from_jax(params, device="cpu")).numpy(),
                               np.asarray(juva.observe_gsub(ref, params)), **_TOL[dtype])
    np.testing.assert_allclose(tuva.basal_rate(from_jax(params, device="cpu")).numpy(),
                               np.asarray(juva.basal_rate(params)), rtol=1e-15 if dtype == np.float64 else 0)


def _openloop(names, dtype, substeps):
    """The reference demo schedule (basal, 80 g meal + bolus at t=100, 1000
    minutes) through the port's minute integrator and the eating state
    machine, for a batch of patients."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    p = from_jax(load_patient_params(names, dtype=dtype), device="cpu")
    basal = tuva.basal_rate(p)
    x = p.x0.clone()
    zero = torch.zeros_like(basal)
    planned, last_cho, eating, foodtaken = zero, zero, zero > 0, zero
    last_qsto = x[:, 0] + x[:, 1]
    bgs, xs = [], []
    for t in range(1000):
        cho = torch.full_like(basal, 80.0 if t == 100 else 0.0)
        ins = basal + (80.0 / 6.0 if t == 100 else 0.0)
        planned = planned + cho
        to_eat = torch.where(planned > 0, torch.clamp(planned, max=tuva.EAT_RATE), zero)
        planned = torch.clamp(planned - to_eat, min=0.0)
        starts = (to_eat > 0) & (last_cho <= 0)
        last_qsto = torch.where(starts, x[:, 0] + x[:, 1], last_qsto)
        foodtaken = torch.where(starts, zero, foodtaken)
        eating = starts | eating
        foodtaken = torch.where(eating, foodtaken + to_eat, foodtaken)
        eating = eating & ~((to_eat <= 0) & (last_cho > 0))
        last_cho = to_eat
        x = tuva.integrate_minute(x, p, to_eat * 1000.0, ins * 6000.0 / p.BW,
                                  last_qsto + foodtaken * 1000.0, substeps=substeps, method="rk45")
        assert x.dtype == tdt
        bgs.append(tuva.observe_gsub(x, p))
        xs.append(x)
    return torch.stack(bgs).numpy(), torch.stack(xs).numpy()


def test_openloop_goldens_f64():
    """The three open-loop reference goldens through rk45 at 2 substeps, at
    tests/test_patient.py's tolerances: BG rel < 1e-5 where BG > 70 and
    abs < 1 mg/dL below; states x0-x2 rel < 1e-2, the rest rel < 1e-4."""
    names = ["adolescent#001", "adult#005", "child#003"]
    bg, xs = _openloop(names, np.float64, substeps=2)
    for i, name in enumerate(names):
        g = load_golden(f"openloop_{name.replace('#', '_')}.npz")
        ref_bg, ok = g["BG"], g["BG"] > 70.0
        assert (np.abs(bg[:, i] - ref_bg)[ok] / ref_bg[ok]).max() < 1e-5, name
        low = (ref_bg > 1.0) & ~ok
        if low.any():
            assert np.abs(bg[:, i] - ref_bg)[low].max() < 1.0
        err = (np.abs(xs[:, i] - g["X"]) / np.maximum(np.abs(g["X"]), 1.0))[ok]
        assert err[:, :3].max() < 1e-2 and err[:, 3:].max() < 1e-4, name


def test_openloop_golden_f32():
    """float32 at one rk45 substep stays within 0.2% of the golden BG
    (tests/test_patient.py::test_openloop_f32_close)."""
    bg, _ = _openloop(["adolescent#001"], np.float32, substeps=1)
    g = load_golden("openloop_adolescent_001.npz")
    assert (np.abs(bg[:, 0] - g["BG"]) / np.abs(g["BG"])).max() < 2e-3


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_risk_matches_jax(dtype):
    rng = np.random.default_rng(3)
    bg = rng.uniform(0.5, 500.0, (4, 20)).astype(dtype)
    bg[0, :5] = 0.0  # the BG < 1 guard
    # float32: fBG cancels near BG = 112 (ln(BG)^1.084 - 5.381), so risk
    # gets an absolute floor of 1e-5, ten times below the rollout's reward
    # tolerance
    tol = _TOL[dtype] if dtype == np.float64 else dict(rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(trisk.fbg(torch.from_numpy(bg)).numpy(),
                               np.asarray(jrisk.fbg(jnp.asarray(bg))), **tol)
    for horizon in (1, 7, 20):
        for g, r in zip(trisk.risk_index(torch.from_numpy(bg), horizon),
                        jrisk.risk_index(jnp.asarray(bg), horizon)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
    for g, r in zip(trisk.risk_scalar(torch.from_numpy(bg)), jrisk.risk_scalar(jnp.asarray(bg))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
    for wlen in (1, 2, 20):
        for fn in ("risk_diff_reward", "neg_risk_reward"):
            g = getattr(trisk, fn)(torch.from_numpy(bg), wlen)
            r = getattr(jrisk, fn)(jnp.asarray(bg), jnp.int32(wlen))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol, err_msg=fn)
