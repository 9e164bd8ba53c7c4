"""Parameter records of the port, as NamedTuples of tensors.

Counterpart of ``simglucose_tpu/core/types.py:22-108``.  Fields and their
order are the JAX package's, so a record means the same thing on both
sides.  :func:`from_jax` converts the JAX package's records (any object
with the same field names, leaves passed through ``np.asarray``) into the
port's — this is how tests feed both sides identical parameters.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device


class PatientParams(NamedTuple):
    """UVA/Padova kinetic parameters of a batch of virtual patients
    (x0 is ``[..., 13]``, every other field ``[...]``)."""

    x0: torch.Tensor
    BW: torch.Tensor
    EGPb: torch.Tensor
    Gb: torch.Tensor
    Ib: torch.Tensor
    kabs: torch.Tensor
    kmax: torch.Tensor
    kmin: torch.Tensor
    b: torch.Tensor
    d: torch.Tensor
    Vg: torch.Tensor
    Vi: torch.Tensor
    Vmx: torch.Tensor
    Km0: torch.Tensor
    k2: torch.Tensor
    k1: torch.Tensor
    p2u: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    m4: torch.Tensor
    m30: torch.Tensor
    ki: torch.Tensor
    kp1: torch.Tensor
    kp2: torch.Tensor
    kp3: torch.Tensor
    f: torch.Tensor
    ke1: torch.Tensor
    ke2: torch.Tensor
    Fsnc: torch.Tensor
    Vm0: torch.Tensor
    kd: torch.Tensor
    ksc: torch.Tensor
    ka1: torch.Tensor
    ka2: torch.Tensor
    u2ss: torch.Tensor


class QuestParams(NamedTuple):
    """Basal-bolus therapy parameters (Quest table)."""

    CR: torch.Tensor
    CF: torch.Tensor
    Age: torch.Tensor
    TDI: torch.Tensor


class SensorParams(NamedTuple):
    """CGM sensor noise constants; ``sample_time`` stays a Python int."""

    PACF: torch.Tensor
    gamma: torch.Tensor
    lam: torch.Tensor
    delta: torch.Tensor
    xi: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


class PumpParams(NamedTuple):
    """Insulin pump quantization parameters."""

    min_bolus: torch.Tensor
    max_bolus: torch.Tensor
    inc_bolus: torch.Tensor
    min_basal: torch.Tensor
    max_basal: torch.Tensor
    inc_basal: torch.Tensor


_RECORDS = {
    cls.__name__: cls
    for cls in (PatientParams, QuestParams, SensorParams, PumpParams)
}


def from_jax(record, device="cuda"):
    """The port's record for a JAX-package record of the same class name.

    Each leaf goes through ``np.asarray`` and keeps its dtype, so a float64
    JAX record gives float64 tensors."""
    cls = _RECORDS.get(type(record).__name__)
    if cls is None:
        raise TypeError(f"no port record for {type(record).__name__}")
    return cls(
        *(
            torch.as_tensor(np.asarray(getattr(record, f)), device=check_device(device))
            for f in cls._fields
        )
    )
