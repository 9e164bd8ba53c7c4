"""Bit-exact reference meal scenario pregeneration (host-side MT19937).

The port's copy of ``simglucose_tpu/compat/scenario.py`` (numpy and
scipy only).

Reproduces ``RandomScenario``'s RNG-consumption order exactly
(reference: simulation/scenario_gen.py):

  * one RandomState(seed) created at reset, which immediately draws a full
    daily plan (:62-64);
  * a NEW plan is drawn from the *continuing* stream whenever ``get_action``
    is called at exactly midnight (t_sec < 1, :20-22) — including at t=0 if
    the episode starts at midnight (the reset-time plan is then discarded);
  * per meal slot, one uniform occurrence draw, then (only if it occurs) a
    truncated-normal time draw and a normal amount draw (:46-58).

The result is a minute-wise meal array suitable for the device's exogenous
scenario mode (``EnvParams.meal_seq``).
"""
from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np
from scipy.stats import truncnorm

MEAL_PROB = [0.95, 0.3, 0.95, 0.3, 0.95, 0.3]
TIME_LB = np.array([5, 9, 10, 14, 16, 20]) * 60.0
TIME_UB = np.array([9, 10, 14, 16, 20, 23]) * 60.0
TIME_MU = np.array([7, 9.5, 12, 15, 18, 21.5]) * 60.0
TIME_SIGMA = np.array([60, 30, 60, 30, 60, 30], dtype=float)
AMOUNT_MU = [45.0, 10.0, 70.0, 10.0, 80.0, 10.0]
AMOUNT_SIGMA = [10.0, 5.0, 10.0, 5.0, 10.0, 5.0]


def _create_daily_plan(rs: np.random.RandomState):
    times, amounts = [], []
    for p, tlb, tub, tbar, tsd, mbar, msd in zip(
        MEAL_PROB, TIME_LB, TIME_UB, TIME_MU, TIME_SIGMA, AMOUNT_MU, AMOUNT_SIGMA
    ):
        if rs.rand() < p:
            tmeal = np.round(
                truncnorm.rvs(
                    a=(tlb - tbar) / tsd,
                    b=(tub - tbar) / tsd,
                    loc=tbar,
                    scale=tsd,
                    random_state=rs,
                )
            )
            times.append(tmeal)
            amounts.append(max(round(rs.normal(mbar, msd)), 0))
    return times, amounts


def reference_meal_seq(
    seed, start_time: datetime, n_minutes: int
) -> np.ndarray:
    """Meal grams for each minute of the episode, bit-exact vs the reference.

    Walks the reference's get_action call sequence minute by minute:
    ``meals[i]`` is the meal delivered at start_time + i minutes.
    """
    rs = np.random.RandomState(seed)
    times, amounts = _create_daily_plan(rs)  # reset-time plan (:62-64)

    meals = np.zeros(n_minutes)
    t = start_time
    for i in range(n_minutes):
        t_sec = (t - datetime.combine(t.date(), datetime.min.time())).total_seconds()
        if t_sec < 1:
            times, amounts = _create_daily_plan(rs)
        t_min = np.floor(t_sec / 60.0)
        if t_min in times:  # first-match (scenario_gen.py:26-31)
            meals[i] = amounts[times.index(t_min)]
        t += timedelta(minutes=1)
    return meals
