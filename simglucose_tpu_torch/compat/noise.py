"""Bit-exact reference CGM noise pregeneration (host-side, numpy MT19937).

The port's copy of ``simglucose_tpu/compat/noise.py`` (numpy and scipy
only).  The reference's noise chain
(sensor/noise_gen.py) is driven by ``np.random.RandomState`` (Mersenne
Twister), which has no device analog.  For verification configs — where
traces must match the reference bitwise — the noise stream is pregenerated
here on the host with the exact same sampling semantics and shipped to the
device as an exogenous array (``EnvParams.noise_seq``):

  * AR(1) lattice at 15-min spacing: e[0] = randn(); e[k] = PACF*(e[k-1]+randn())
    (noise_gen.py:85-88)
  * Johnson-SU transform per lattice point (noise_gen.py:11-12)
  * per 10-lattice-interval block, cubic interpolation (scipy interp1d
    kind='cubic', i.e. a not-a-knot cubic B-spline over the 11 points) down
    to the sensor sample_time, dropping each block's t=0 point
    (noise_gen.py:30-56: PRECOMPUTE=10, the last lattice point carries over
    as the next block's first).
"""
from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import interp1d

MDL_SAMPLE_TIME = 15
PRECOMPUTE = 10


def johnson_transform_su(xi, lam, gamma, delta, x):
    return xi + lam * np.sinh((x - gamma) / delta)


def reference_cgm_noise(sensor_rec: dict, seed, n: int) -> np.ndarray:
    """First ``n`` noise values popped by the reference's CGMNoise(seed).

    ``sensor_rec`` is a raw sensor record
    (simglucose_tpu_torch.params.sensor_record)
    with keys PACF, gamma, lambda, delta, xi, sample_time.
    """
    rs = np.random.RandomState(seed)
    pacf = float(sensor_rec["PACF"])
    xi, lam = float(sensor_rec["xi"]), float(sensor_rec["lambda"])
    gamma, delta = float(sensor_rec["gamma"]), float(sensor_rec["delta"])
    sample_time = float(sensor_rec["sample_time"])

    e = rs.randn()  # lattice point 0 (consumed at CGMNoise construction)
    eps_carry = johnson_transform_su(xi, lam, gamma, delta, e)

    per_block = int(
        math.floor(PRECOMPUTE * MDL_SAMPLE_TIME / sample_time)
    )  # samples yielded per block (nsample - 1)
    n_blocks = -(-n // per_block)

    t15 = np.arange(PRECOMPUTE + 1) * MDL_SAMPLE_TIME
    t = np.arange(per_block + 1) * sample_time

    out = []
    for _ in range(n_blocks):
        lattice = [eps_carry]
        for _ in range(PRECOMPUTE):
            e = pacf * (e + rs.randn())
            lattice.append(johnson_transform_su(xi, lam, gamma, delta, e))
        eps_carry = lattice[-1]
        block = interp1d(t15, np.asarray(lattice), kind="cubic")(t)
        out.append(block[1:])  # the t=0 point is dropped (noise_gen.py:47)
    return np.concatenate(out)[:n]
