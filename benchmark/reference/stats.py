"""The per-patient statistics of an evaluation as simglucose v0.2.2 reports
them, worked out from a ``[T, B]`` BG plane (mg/dL) over the whole trace:

* the mean, least and largest BG;
* the shares of samples in its zones, in percent, as
  ``analysis/report.py::percent_stats`` counts them: 70-180 inclusive,
  below 70, above 180, below 50, above 250;
* the risk indices of ``analysis/risk.py::risk_index`` with the horizon
  the trace's length: f(BG) = 1.509 (ln(BG)^1.084 - 5.381) and r = 10 f^2
  (Kovatchev et al., Diabetes Care 1997); LBGI the mean of r over the
  samples with f < 0, HBGI over those with f > 0, each 0 where there are
  none (NumPy's mean of an empty selection is NaN, which upstream turns
  into 0), and RI their sum.

Upstream averages over the low (high) samples alone, not over the whole
trace as Kovatchev's paper does; this follows upstream.  One departure: a
BG under 1 mg/dL (a patient driven into deep hypoglycaemia) is taken as 1
before its logarithm, as :func:`benchmark.reference.rollout.risk` takes
it, where upstream's power of a logarithm under 0 is NaN.  The reductions
are in float64 whatever the plane's dtype: what a comparison tests is the
trajectory, not the precision of a sum.
"""
from __future__ import annotations

import torch

STATS = ("BG_mean", "BG_min", "BG_max", "percent_in_70_180", "percent_below_70",
         "percent_above_180", "percent_below_50", "percent_above_250", "LBGI", "HBGI",
         "risk_index")


def _subset_mean(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(0)
    return torch.where(n > 0, (r * mask).sum(0) / n.clamp(min=1), torch.zeros_like(r[0]))


def cohort_stats(bg: torch.Tensor) -> dict:
    """``{name: [B] float64}`` for each of :data:`STATS`."""
    bg = bg.double()
    pct = lambda m: 100.0 * m.double().mean(0)
    f = 1.509 * (torch.pow(torch.log(torch.clamp(bg, min=1.0)), 1.084) - 5.381)
    r = 10.0 * f * f
    lbgi, hbgi = _subset_mean(r, f < 0), _subset_mean(r, f > 0)
    return {"BG_mean": bg.mean(0), "BG_min": bg.min(0).values, "BG_max": bg.max(0).values,
            "percent_in_70_180": pct((bg >= 70.0) & (bg <= 180.0)),
            "percent_below_70": pct(bg < 70.0), "percent_above_180": pct(bg > 180.0),
            "percent_below_50": pct(bg < 50.0), "percent_above_250": pct(bg > 250.0),
            "LBGI": lbgi, "HBGI": hbgi, "risk_index": lbgi + hbgi}
