"""UVA/Padova 2008 glucose-insulin kinetics in PyTorch.

Counterpart of ``simglucose_tpu/models/uva_padova.py:39-250``: the same
13-state right-hand side (reference ``T1DPatient.model``,
patient/t1dpatient.py:118-208) as branchless tensor math, the fixed-step
RK4 and Dormand-Prince RK45 integrators, and the one-minute advance.  Every
function works in the dtype of the tensors it is given (float32 or
float64) and broadcasts over leading batch axes.  The CUDA kernel's copy of
the RHS lives in ``csrc/rollout_math.cuh`` and follows this one operation
for operation.
"""
from __future__ import annotations

import functools

import torch

from simglucose_tpu_torch.core.types import PatientParams

SAMPLE_TIME = 1  # min — patient internal step
EAT_RATE = 5.0  # g/min CHO


def model_rhs_parts(xs: tuple, params: PatientParams, d_mg, insulin_rate, Dbar) -> tuple:
    """dx/dt on a tuple of 13 per-state tensors (the layout-agnostic form)."""
    p = params
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12 = xs

    qsto = x0 + x1

    # gastric emptying: tanh-interpolated while a meal is in transit, kmax
    # otherwise; the 1/Dbar is guarded against the branch selected away
    meal_on = Dbar > 0
    safe_Dbar = torch.where(meal_on, Dbar, torch.ones_like(Dbar))
    aa = 5.0 / 2.0 / (1.0 - p.b) / safe_Dbar
    cc = 5.0 / 2.0 / p.d / safe_Dbar
    kgut_meal = p.kmin + (p.kmax - p.kmin) / 2.0 * (
        torch.tanh(aa * (qsto - p.b * safe_Dbar))
        - torch.tanh(cc * (qsto - p.d * safe_Dbar))
        + 2.0
    )
    kgut = torch.where(meal_on, kgut_meal, p.kmax)

    dx0 = -p.kmax * x0 + d_mg
    dx1 = p.kmax * x0 - x1 * kgut
    dx2 = kgut * x1 - p.kabs * x2

    Rat = p.f * p.kabs * x2 / p.BW
    EGPt = p.kp1 - p.kp2 * x3 - p.kp3 * x8
    Uiit = p.Fsnc

    zero = torch.zeros_like(x3)
    Et = torch.where(x3 > p.ke2, p.ke1 * (x3 - p.ke2), zero)

    dx3 = torch.clamp(EGPt, min=0.0) + Rat - Uiit - Et - p.k1 * x3 + p.k2 * x4
    dx3 = torch.where(x3 >= 0, dx3, zero)

    Vmt = p.Vm0 + p.Vmx * x6
    Uidt = Vmt * x4 / (p.Km0 + x4)
    dx4 = -Uidt + p.k1 * x3 - p.k2 * x4
    dx4 = torch.where(x4 >= 0, dx4, zero)

    dx5 = -(p.m2 + p.m4) * x5 + p.m1 * x9 + p.ka1 * x10 + p.ka2 * x11
    It = x5 / p.Vi
    dx5 = torch.where(x5 >= 0, dx5, zero)

    dx6 = -p.p2u * x6 + p.p2u * (It - p.Ib)
    dx7 = -p.ki * (x7 - It)
    dx8 = -p.ki * (x8 - x7)

    dx9 = -(p.m1 + p.m30) * x9 + p.m2 * x5
    dx9 = torch.where(x9 >= 0, dx9, zero)

    dx10 = insulin_rate - (p.ka1 + p.kd) * x10
    dx10 = torch.where(x10 >= 0, dx10, zero)
    dx11 = p.kd * x10 - p.ka2 * x11
    dx11 = torch.where(x11 >= 0, dx11, zero)

    dx12 = -p.ksc * x12 + p.ksc * x3
    dx12 = torch.where(x12 >= 0, dx12, zero)

    return (dx0, dx1, dx2, dx3, dx4, dx5, dx6, dx7, dx8, dx9, dx10, dx11, dx12)


def model_rhs(x: torch.Tensor, params: PatientParams, d_mg, insulin_rate, Dbar) -> torch.Tensor:
    """dx/dt of a ``[..., 13]`` state."""
    dxs = model_rhs_parts(x.unbind(-1), params, d_mg, insulin_rate, Dbar)
    return torch.stack(dxs, dim=-1)


# Dormand-Prince 5(4) tableau (the one scipy's dopri5 uses), fixed step
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)


def _axpy(x, a, k):
    """x + a*k on a tensor or a tuple of per-state tensors."""
    if isinstance(x, tuple):
        return tuple(xi + a * ki for xi, ki in zip(x, k))
    return x + a * k


def rk45_step(f, x, h):
    """One fixed-step Dormand-Prince step of size ``h`` (a Python float or
    0-d tensor of the state's dtype) for autonomous ``f``."""
    ks = []
    for stage in range(7):
        xi = x
        for a, k in zip(_DP_A[stage], ks):
            xi = _axpy(xi, h * a, k)
        ks.append(f(xi))
    out = x
    for b, k in zip(_DP_B, ks):
        if b != 0.0:
            out = _axpy(out, h * b, k)
    return out


def rk4_step(f, x, h):
    """One classic RK4 step of size ``h`` for autonomous ``f``."""
    k1 = f(x)
    k2 = f(_axpy(x, 0.5 * h, k1))
    k3 = f(_axpy(x, 0.5 * h, k2))
    k4 = f(_axpy(x, h, k3))
    if isinstance(x, tuple):
        ksum = tuple(a + 2.0 * b + 2.0 * c + d for a, b, c, d in zip(k1, k2, k3, k4))
    else:
        ksum = k1 + 2.0 * k2 + 2.0 * k3 + k4
    return _axpy(x, h / 6.0, ksum)


_STEPPERS = {"rk45": rk45_step, "rk4": rk4_step}


@functools.lru_cache(maxsize=None)
def _step_size(substeps: int, dtype: torch.dtype) -> torch.Tensor:
    """``1/substeps`` rounded to ``dtype``, as a 0-d CPU tensor made once:
    a CUDA op reads a 0-d CPU tensor as a scalar of its dtype (no copy to
    the card per simulated minute), and the products the steppers form
    with it round as they would on a tensor of the state's device."""
    return torch.tensor(1.0 / substeps, dtype=dtype)


def integrate_minute(
    x: torch.Tensor,
    params: PatientParams,
    d_mg,
    insulin_rate,
    Dbar,
    substeps: int = 2,
    method: str = "rk45",
) -> torch.Tensor:
    """Advance a ``[..., 13]`` state by one minute with inputs held constant.

    The step size is rounded to the state's dtype first, as the JAX
    package's ``jnp.asarray(1/substeps, x.dtype)`` does."""
    stepper = _STEPPERS[method]
    h = _step_size(substeps, x.dtype)
    f = lambda xx: model_rhs(xx, params, d_mg, insulin_rate, Dbar)
    for _ in range(substeps):
        x = stepper(f, x, h)
    return x


def observe_gsub(x: torch.Tensor, params: PatientParams) -> torch.Tensor:
    """Subcutaneous glucose x12 / Vg in mg/dL."""
    return x[..., 12] / params.Vg


def basal_rate(params: PatientParams) -> torch.Tensor:
    """Steady-state basal insulin rate u2ss * BW / 6000 in U/min."""
    return params.u2ss * params.BW / 6000.0
