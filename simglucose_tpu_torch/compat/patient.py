"""Bit-exact reference random initial BG (host-side MT19937).

The port's copy of ``simglucose_tpu/compat/patient.py`` (numpy only).

The reference perturbs the glucose-related initial states x[3], x[4], x[12]
with ``RandomState(seed).multivariate_normal(mean, diag(0.1*mean))``
(reference: patient/t1dpatient.py:256-270).  numpy's multivariate_normal
factorizes the covariance by SVD, which permutes/sign-flips the component
mapping for diagonal covariances — so exact parity requires calling numpy
itself rather than re-deriving mean + sqrt(var)*z.
"""
from __future__ import annotations

import numpy as np


def reference_init_state(x0: np.ndarray, seed) -> np.ndarray:
    """Return a copy of x0 with the reference's random_init_bg applied."""
    x0 = np.array(x0, dtype=float, copy=True)
    rs = np.random.RandomState(seed)
    mean = [1.0 * x0[3], 1.0 * x0[4], 1.0 * x0[12]]
    cov = np.diag([0.1 * x0[3], 0.1 * x0[4], 0.1 * x0[12]])
    bg_init = rs.multivariate_normal(mean, cov)
    x0[3] = 1.0 * bg_init[0]
    x0[4] = 1.0 * bg_init[1]
    x0[12] = 1.0 * bg_init[2]
    return x0
