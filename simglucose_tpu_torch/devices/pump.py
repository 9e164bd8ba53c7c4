"""Insulin pump quantization in PyTorch.

Counterpart of ``simglucose_tpu/devices/pump.py:16-29``: a command in U/min
goes to pmol/min, is rounded to the pump's increment (half to even, as
``jnp.round`` and numpy do: ``torch.round`` is the same rule), clamped to
the pump's limits and goes back to U/min.  Broadcasts over any batch shape.
"""
from __future__ import annotations

import torch

from simglucose_tpu_torch.core.types import PumpParams

U2PMOL = 6000.0  # U -> pmol


def pump_bolus(params: PumpParams, amount: torch.Tensor) -> torch.Tensor:
    """Quantize and clamp a bolus command in U/min."""
    bol = amount * U2PMOL
    bol = torch.round(bol / params.inc_bolus) * params.inc_bolus
    bol = bol / U2PMOL
    return torch.clamp(bol, params.min_bolus, params.max_bolus)


def pump_basal(params: PumpParams, amount: torch.Tensor) -> torch.Tensor:
    """Quantize and clamp a basal command in U/min."""
    bas = amount * U2PMOL
    bas = torch.round(bas / params.inc_basal) * params.inc_basal
    bas = bas / U2PMOL
    return torch.clamp(bas, params.min_basal, params.max_basal)
