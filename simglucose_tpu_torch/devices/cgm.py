"""CGM sensor in PyTorch.

Counterpart of ``simglucose_tpu/devices/cgm.py:31-102``: at each sampling
minute the sensor adds one value of the colored-noise stream to the
patient's glucose and clamps it to the hardware range; between samples the
env reads ``last_CGM`` (zero-order hold).  Two noise sources:

* native: the streaming AR(1) / Johnson-SU / Catmull-Rom chain of
  :mod:`simglucose_tpu_torch.ops.noise`, drawn from the port's Philox
  streams;
* exogenous: ``noise_seq[..., sample_count]``, caller-supplied values such
  as the reference's MT19937 noise (:mod:`simglucose_tpu_torch.compat.noise`).

Batch-native over the sensors' leading axes.  The JAX package's per-step
``noise_value`` (its scan-fed pregeneration mode) is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from simglucose_tpu_torch.core.types import SensorParams, SensorState
from simglucose_tpu_torch.ops.noise import noise_lattice_init, noise_next


def take(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``seq[..., idx]`` per lane: ``seq`` ``[..., N]`` (batch axes
    broadcast against ``idx``), the index clamped into ``0..N-1`` as JAX
    clamps a gather's index."""
    idx = torch.clamp(idx.to(torch.int64), 0, seq.shape[-1] - 1)
    seq = seq.expand(idx.shape + seq.shape[-1:])
    return torch.gather(seq, -1, idx[..., None])[..., 0]


def sensor_init(params: SensorParams, key: torch.Tensor, dtype=torch.float32) -> SensorState:
    """Fresh sensor state; the noise lattice drawn from ``key``'s stream."""
    e, lattice, seg, lattice_next = noise_lattice_init(params, key, dtype=dtype)
    return SensorState(
        last_CGM=torch.zeros_like(e),
        e=e,
        lattice=lattice,
        seg=seg,
        lattice_next=lattice_next,
        sample_count=torch.zeros_like(seg),
        key=key,
    )


def sensor_sample(
    params: SensorParams,
    sample_time: int,
    state: SensorState,
    BG: torch.Tensor,
    noise_seq: Optional[torch.Tensor] = None,
) -> Tuple[SensorState, torch.Tensor]:
    """One CGM sample: BG + noise, clamped to the sensor's range.  With
    ``noise_seq`` the noise is ``noise_seq[..., sample_count]`` and the
    lattice state is left as it is."""
    if noise_seq is not None:
        noise = take(noise_seq, state.sample_count)
        chain = (state.e, state.lattice, state.seg, state.lattice_next)
    else:
        noise, chain = noise_next(
            params, sample_time, state.e, state.lattice, state.seg, state.lattice_next,
            state.sample_count, state.key,
        )
    CGM = torch.clamp(BG + noise, params.min, params.max)
    new_state = SensorState(CGM, *chain, sample_count=state.sample_count + 1, key=state.key)
    return new_state, CGM
