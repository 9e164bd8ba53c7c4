"""Streaming CGM noise in PyTorch.

Counterpart of ``simglucose_tpu/ops/noise.py:47-128``: the reference's
colored CGM noise (an AR(1) recursion on a 15-min lattice, the Johnson-SU
transform of each lattice value, a cubic through the lattice resampled at
the sensor's period) as a streaming state machine.  The state carries the
raw AR(1) value and the 4 transformed lattice points around the current
15-min segment; each new lattice point costs one normal, each sample one
local Catmull-Rom cubic.  Batch-native: every function takes the sensors'
leading batch axes, and phases that have diverged between lanes (after an
auto-reset) advance by masked selects.

The draw of each lattice normal is split from the lattice arithmetic
(:func:`noise_lattice_from_normals`, :func:`noise_advance`), so that the
same normals can be fed to this module and to the JAX one.  The normals
themselves come from the port's Philox streams
(:mod:`simglucose_tpu_torch.ops.streams`, site ``SITE_CGM``, the lattice
index as counter), where the JAX package folds the lattice index into a
threefry key: the two agree by law.

Sample timeline: the n-th value (n = 0, 1, ...) sits at lattice time
``(n + 1) * sample_time`` minutes (the reference's block resampler drops
each block's t=0 point).  ``noise_pregenerate`` (pregeneration for the
XLA scan) is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from simglucose_tpu_torch.core.types import SensorParams
from simglucose_tpu_torch.ops.streams import SITE_CGM, normal

MDL_SAMPLE_TIME = 15  # min between AR(1) lattice points


def johnson_transform_su(params: SensorParams, x: torch.Tensor) -> torch.Tensor:
    """xi + lambda * sinh((x - gamma) / delta)."""
    return params.xi + params.lam * torch.sinh((x - params.gamma) / params.delta)


def noise_lattice_from_normals(params: SensorParams, z0, z1, z2):
    """The lattice window of segment 0 from the first three normals.

    Returns ``(e, lattice[..., 4], seg, lattice_next)``: the lattice holds
    the transformed values at lattice indices -1, 0, 1, 2, with the phantom
    index -1 clamped to 0.  Invariant thereafter: the lattice covers
    indices ``seg-1 .. seg+2`` and ``lattice_next == seg + 3``."""
    e0 = z0  # the first lattice point is a plain normal
    e1 = params.PACF * (e0 + z1)
    e2 = params.PACF * (e1 + z2)
    eps0 = johnson_transform_su(params, e0)
    eps1 = johnson_transform_su(params, e1)
    eps2 = johnson_transform_su(params, e2)
    lattice = torch.stack(torch.broadcast_tensors(eps0, eps0, eps1, eps2), dim=-1)
    ints = torch.zeros(lattice.shape[:-1], dtype=torch.int32, device=lattice.device)
    return e2, lattice, ints, ints + 3


def noise_lattice_init(params: SensorParams, key: torch.Tensor, dtype=torch.float32):
    """:func:`noise_lattice_from_normals` of the normals at lattice indices
    0, 1, 2 of ``key``'s stream."""
    z = [normal(key, SITE_CGM, j, dtype) for j in range(3)]
    return noise_lattice_from_normals(params, *z)


def _catmull_rom(lattice: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cubic Hermite through lattice[..., 1] and lattice[..., 2] at u in
    [0, 1], with central-difference tangents (Catmull-Rom)."""
    p0, p1, p2, p3 = lattice.unbind(-1)
    m1 = 0.5 * (p2 - p0)
    m2 = 0.5 * (p3 - p1)
    u2 = u * u
    u3 = u2 * u
    return (
        (2.0 * u3 - 3.0 * u2 + 1.0) * p1
        + (u3 - 2.0 * u2 + u) * m1
        + (-2.0 * u3 + 3.0 * u2) * p2
        + (u3 - u2) * m2
    )


def noise_advance(
    params: SensorParams,
    sample_time: int,
    e: torch.Tensor,
    lattice: torch.Tensor,
    seg: torch.Tensor,
    lattice_next: torch.Tensor,
    sample_count: torch.Tensor,
    z: torch.Tensor,
) -> Tuple[torch.Tensor, tuple]:
    """Noise value of sample ``sample_count``, advancing the lattice by one
    point where the sample needs it, with ``z`` as that point's normal.
    ``sample_time`` <= 5 < 15, so a sample needs at most one new point.

    Returns ``(value, (e, lattice, seg, lattice_next))``."""
    tau = (sample_count + 1) * sample_time  # minutes on the lattice timeline
    k = torch.div(tau, MDL_SAMPLE_TIME, rounding_mode="floor").to(torch.int32)
    u = (tau - k * MDL_SAMPLE_TIME).to(lattice.dtype) / MDL_SAMPLE_TIME

    need = (k + 2) >= lattice_next
    e_new = params.PACF * (e + z)
    eps_new = johnson_transform_su(params, e_new)
    e = torch.where(need, e_new, e)
    shifted = torch.cat([lattice[..., 1:], eps_new[..., None].expand_as(lattice[..., :1])], dim=-1)
    lattice = torch.where(need[..., None], shifted, lattice)
    lattice_next = torch.where(need, lattice_next + 1, lattice_next)
    return _catmull_rom(lattice, u), (e, lattice, k, lattice_next)


def noise_next(
    params: SensorParams,
    sample_time: int,
    e: torch.Tensor,
    lattice: torch.Tensor,
    seg: torch.Tensor,
    lattice_next: torch.Tensor,
    sample_count: torch.Tensor,
    key: torch.Tensor,
) -> Tuple[torch.Tensor, tuple]:
    """:func:`noise_advance` with the normal of lattice point
    ``lattice_next`` of ``key``'s stream (drawn on every lane, used where
    the lattice advances)."""
    z = normal(key, SITE_CGM, lattice_next, lattice.dtype)
    return noise_advance(params, sample_time, e, lattice, seg, lattice_next, sample_count, z)
