"""Magni/Kovatchev blood-glucose risk index in PyTorch.

Counterpart of ``simglucose_tpu/analysis/risk.py:17-75``:
``fBG = 1.509 * (ln(BG)^1.084 - 5.381)``, LBGI/HBGI the means of ``10*fBG^2``
over the samples of each sign in the window (0 for an empty subset), and
RI = LBGI + HBGI.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fbg(BG: torch.Tensor) -> torch.Tensor:
    """Risk-space transform of BG in mg/dL (BG below 1 is clamped to 1)."""
    logbg = torch.log(torch.clamp(BG, min=1.0))
    return 1.509 * (torch.pow(logbg, 1.084) - 5.381)


def risk_index(BG: torch.Tensor, horizon: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(LBGI, HBGI, RI) over the last ``horizon`` samples of the last axis."""
    window = BG[..., -horizon:] if BG.ndim else BG[None]
    f = fbg(window)
    r = 10.0 * f * f
    neg = f < 0
    pos = f > 0
    nneg = neg.sum(dim=-1)
    npos = pos.sum(dim=-1)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    LBGI = torch.where(nneg > 0, (r * neg).sum(dim=-1) / nneg.clamp(min=1), zero)
    HBGI = torch.where(npos > 0, (r * pos).sum(dim=-1) / npos.clamp(min=1), zero)
    return LBGI, HBGI, LBGI + HBGI


def risk_scalar(BG: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(LBGI, HBGI, RI) of single BG samples, elementwise."""
    f = fbg(BG)
    r = 10.0 * f * f
    zero = torch.zeros_like(r)
    LBGI = torch.where(f < 0, r, zero)
    HBGI = torch.where(f > 0, r, zero)
    return LBGI, HBGI, LBGI + HBGI


def neg_risk_reward(cgm_window: torch.Tensor, window_len: torch.Tensor) -> torch.Tensor:
    """Dense reward -RI(CGM[t]) / 10 over a chronological ``[..., W]`` window."""
    _, _, r_now = risk_scalar(cgm_window[..., -1])
    return -r_now / 10.0


def risk_diff_reward(cgm_window: torch.Tensor, window_len) -> torch.Tensor:
    """Default reward risk(CGM[t-1]) - risk(CGM[t]); 0 while fewer than two
    samples exist (reference simulation/env.py:27-33)."""
    _, _, r_now = risk_scalar(cgm_window[..., -1])
    _, _, r_prev = risk_scalar(cgm_window[..., -2])
    return torch.where(
        torch.as_tensor(window_len, device=r_now.device) >= 2,
        r_prev - r_now,
        torch.zeros_like(r_now),
    )
