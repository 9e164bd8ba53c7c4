"""Custom meal scenarios.

Only :func:`parse_meal_times` is ported here, from
``simglucose_tpu/envs/gym_env.py:54-75``.  It is pure Python, but its JAX
module imports jax, so the port keeps its own copy.  The random daily meal
law lives in the rollout kernel (``ops/rollout.py``).
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional, Sequence, Tuple, Union

import numpy as np

MealSpec = Sequence[Tuple[Union[float, timedelta, datetime], float]]


def parse_meal_times(
    scenario: MealSpec, start_time: Optional[datetime] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Reference-style custom scenario -> (episode minutes int32, grams).

    Times may be float hours since the start, ``timedelta`` since the
    start, or absolute ``datetime`` (requires ``start_time``), the three
    forms of reference simulation/scenario.py:48-59."""
    times, amounts = [], []
    for t, amt in scenario:
        if isinstance(t, datetime):
            if start_time is None:
                raise ValueError("datetime meal times require start_time")
            minutes = (t - start_time).total_seconds() / 60.0
        elif isinstance(t, timedelta):
            minutes = t.total_seconds() / 60.0
        else:
            minutes = float(t) * 60.0
        times.append(int(round(minutes)))
        amounts.append(float(amt))
    return np.asarray(times, np.int32), np.asarray(amounts)
