"""Meal scenarios in PyTorch.

Counterpart of ``simglucose_tpu/scenario/meal.py:38-268`` (random daily
plans) and of ``parse_meal_times`` (``simglucose_tpu/envs/gym_env.py:54-75``,
custom scenarios).  The reference's ``RandomScenario`` draws a fresh daily
plan whenever the clock crosses midnight: 6 meal slots with occurrence
probabilities, truncated-normal times and normal amounts.  Here a plan is
materialized as ``(times[..., 6], amounts[..., 6])`` in the scenario state
and redrawn from the port's Philox streams
(:mod:`simglucose_tpu_torch.ops.streams`, plan index 0 at reset, day + 1
after a midnight); a meal is found by an exact minute-of-day match, the
first slot winning, as the reference's ``list.index``.

The draw of a plan's 18 uniforms is split from its transform
(:func:`create_daily_plan`), so that the same uniforms can be fed to this
module and to the JAX one.  Batch-native over the envs' leading axes.
``meals_pregenerate`` (pregeneration for the XLA scan) is not ported; the
reference's MT19937 meal stream is :mod:`simglucose_tpu_torch.compat.scenario`.
"""
from __future__ import annotations

import functools
from datetime import datetime, timedelta
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from simglucose_tpu_torch.core.types import ScenarioState
from simglucose_tpu_torch.ops.streams import meal_uniforms

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


MINUTES_PER_DAY = 1440

# Meal slot distributions (reference scenario_gen.py:36-44)
MEAL_PROB = (0.95, 0.3, 0.95, 0.3, 0.95, 0.3)
TIME_LB = tuple(x * 60.0 for x in (5, 9, 10, 14, 16, 20))
TIME_UB = tuple(x * 60.0 for x in (9, 10, 14, 16, 20, 23))
TIME_MU = tuple(x * 60.0 for x in (7, 9.5, 12, 15, 18, 21.5))
TIME_SIGMA = (60.0, 30.0, 60.0, 30.0, 60.0, 30.0)
AMOUNT_MU = (45.0, 10.0, 70.0, 10.0, 80.0, 10.0)
AMOUNT_SIGMA = (10.0, 5.0, 10.0, 5.0, 10.0, 5.0)


@functools.lru_cache(maxsize=None)
def _slot_constants(dtype: torch.dtype, device: torch.device):
    """The slots' constants as tensors of ``dtype`` on ``device``, made
    once: (prob, mu, sigma, amount mu, amount sigma, CDF at the lower
    bound, CDF at the upper bound)."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    lb, ub, mu, sigma = t(TIME_LB), t(TIME_UB), t(TIME_MU), t(TIME_SIGMA)
    a_cdf = torch.special.ndtr((lb - mu) / sigma)
    b_cdf = torch.special.ndtr((ub - mu) / sigma)
    return t(MEAL_PROB), mu, sigma, t(AMOUNT_MU), t(AMOUNT_SIGMA), a_cdf, b_cdf


def create_daily_plan(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One day's plan from 18 uniforms ``u[..., 18]`` in (0, 1): slot
    occurrence (``u[..., :6]``), truncated-normal times by inverse CDF
    (``u[..., 6:12]``) and normal amounts (``u[..., 12:]``).

    Returns ``(times[..., 6], amounts[..., 6])`` in ``u``'s dtype: times
    rounded to whole minutes of day, amounts to whole grams floored at 0;
    a skipped slot has time -1 (it matches no minute) and amount 0."""
    prob, mu, sigma, amu, asig, a_cdf, b_cdf = _slot_constants(u.dtype, u.device)
    occurs = u[..., :6] < prob
    zt = torch.special.ndtri(a_cdf + u[..., 6:12] * (b_cdf - a_cdf))
    times = torch.round(mu + sigma * zt)
    z_amt = torch.special.ndtri(u[..., 12:18])
    amounts = torch.clamp(torch.round(amu + asig * z_amt), min=0.0)
    return torch.where(occurs, times, -1.0), torch.where(occurs, amounts, 0.0)


def draw_daily_plan(key: torch.Tensor, index, dtype=torch.float32):
    """:func:`create_daily_plan` of plan ``index`` of ``key``'s stream."""
    return create_daily_plan(meal_uniforms(key, index, dtype))


def scenario_init(key: torch.Tensor, start_min, dtype=torch.float32) -> ScenarioState:
    """The scenario at episode start; ``start_min`` is the start's minute of
    day (an int or an int tensor).

    The reference redraws the plan when a step lands exactly on midnight,
    so an episode that starts at midnight discards its reset-time plan: the
    initial plan is then tagged day -1 and the first lookup (day 0) redraws
    it."""
    times, amounts = draw_daily_plan(key, 0, dtype)
    batch, dev = key.shape[:-1], key.device
    if isinstance(start_min, torch.Tensor):
        start_min = start_min.to(torch.int32).expand(batch)
    else:
        start_min = torch.full(batch, int(start_min), dtype=torch.int32, device=dev)
    day = torch.where(start_min == 0, -1, 0).to(torch.int32)
    return ScenarioState(meal_times=times, meal_amounts=amounts, day=day, start_min=start_min,
                         key=key)


def _first_match(match: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """The amount of the first True slot of ``match[..., K]`` (0 where
    none); ``amounts[..., K]`` broadcast against it."""
    first = torch.argmax(match.to(torch.uint8), dim=-1, keepdim=True)
    amounts = amounts.expand(match.shape[:-1] + amounts.shape[-1:])
    hit = torch.gather(amounts, -1, first)[..., 0]
    return torch.where(match.any(dim=-1), hit, 0.0)


def _lookup(times: torch.Tensor, amounts: torch.Tensor, minute_of_day: torch.Tensor):
    """First-match exact-minute meal lookup in a plan."""
    return _first_match(times == minute_of_day.to(times.dtype)[..., None], amounts)


def _step_minutes(state: ScenarioState, t0: torch.Tensor, sample_time: int) -> torch.Tensor:
    """``[..., sample_time]`` minutes since midnight of the start day of
    the step's minutes t0, t0+1, ..."""
    offs = torch.arange(sample_time, dtype=torch.int32, device=t0.device)
    return (state.start_min + t0.to(torch.int32))[..., None] + offs


def scenario_meals_for_step(state: ScenarioState, t0: torch.Tensor, sample_time: int,
                            dtype=torch.float32):
    """Meals (g) of the ``sample_time`` minutes t0, t0+1, ... of one env
    step: ``(state, meals[..., sample_time])``.

    The midnight redraw is hoisted out of the minutes: one step spans at
    most two days, so one candidate next-day plan is drawn on every lane
    (kept where the step's last minute has entered a new day), and each
    minute reads the plan of its own day."""
    mins = _step_minutes(state, t0, sample_time)
    days = torch.div(mins, MINUTES_PER_DAY, rounding_mode="floor")
    mods = mins - days * MINUTES_PER_DAY

    day_end = days[..., -1]
    regen = day_end > state.day
    cand_times, cand_amounts = draw_daily_plan(state.key, day_end + 1, dtype)
    new_times = torch.where(regen[..., None], cand_times, state.meal_times)
    new_amounts = torch.where(regen[..., None], cand_amounts, state.meal_amounts)
    new_day = torch.where(regen, day_end, state.day)

    meals = []
    for i in range(sample_time):
        use_new = (days[..., i] >= new_day)[..., None]
        times_i = torch.where(use_new, new_times, state.meal_times)
        amounts_i = torch.where(use_new, new_amounts, state.meal_amounts)
        meals.append(_lookup(times_i, amounts_i, mods[..., i]))
    new_state = state._replace(meal_times=new_times, meal_amounts=new_amounts, day=new_day)
    return new_state, torch.stack(meals, dim=-1)


def scenario_lookup_for_step(state: ScenarioState, t0: torch.Tensor, sample_time: int):
    """Meals of one env step without the midnight redraw check
    (``[..., sample_time]``).  Deferring the redraw is exact while no meal
    of either plan can fall in the deferred minutes: every slot lies in
    05:00-23:00."""
    mins = _step_minutes(state, t0, sample_time)
    mods = torch.remainder(mins, MINUTES_PER_DAY)
    return torch.stack(
        [_lookup(state.meal_times, state.meal_amounts, mods[..., i]) for i in range(sample_time)],
        dim=-1,
    )


def scenario_regen_now(state: ScenarioState, t_now: torch.Tensor, dtype=torch.float32):
    """Catch the scenario up to the patient clock ``t_now`` (minutes since
    episode start): where the clock has entered a new day since the plan was
    drawn, redraw it with the plan index the streaming path
    (:func:`scenario_meals_for_step`) uses at that midnight, day + 1."""
    day_now = torch.div(state.start_min + t_now.to(torch.int32), MINUTES_PER_DAY,
                        rounding_mode="floor")
    regen = day_now > state.day
    cand_times, cand_amounts = draw_daily_plan(state.key, day_now + 1, dtype)
    return state._replace(
        meal_times=torch.where(regen[..., None], cand_times, state.meal_times),
        meal_amounts=torch.where(regen[..., None], cand_amounts, state.meal_amounts),
        day=torch.where(regen, day_now, state.day),
    )


def custom_meals_for_step(times_min: torch.Tensor, amounts: torch.Tensor, t0: torch.Tensor,
                          sample_time: int) -> torch.Tensor:
    """Custom scenario lookup: ``times_min[..., K]`` are exact minutes since
    episode start, the first match wins.  Returns ``[..., sample_time]``."""
    offs = torch.arange(sample_time, dtype=torch.int32, device=t0.device)
    mins = t0.to(torch.int32)[..., None] + offs  # [..., st]
    match = times_min[..., None, :] == mins[..., None]  # [..., st, K]
    return _first_match(match, amounts[..., None, :])
