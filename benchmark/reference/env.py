"""simglucose's Gymnasium env, vectorised with auto-reset, written out
plainly: per env and ``step(action)`` the Insulet pump's quantization of
the basal command (bolus 0), ``sample_time`` RK4 minutes of the UVA/Padova
2008 ODE (Dalla Man et al., IEEE TBME 2007; simglucose v0.2.2's
``T1DPatient``) with the random scenario's meals and the eating state
machine, a CGM sample at the step's last minute (zero-order hold before
it), the step's means, the risk-difference reward, termination at a mean
BG under 70 or over 350 mg/dL, truncation at the horizon and Gymnasium's
SAME_STEP auto-reset: where an episode ends the env hands back the new
episode's reset observation and keeps the terminal step's observation, BG
and risk as ``final_observation`` / ``final_info``.

The physics, the noise chain's pieces, the pump, the risk and the inverse
normal CDF are :mod:`benchmark.reference.rollout`'s, imported.  What this
file adds is the env's own episode law and its streams, which are not the
rollout kernel's: every env draws from Philox-4x32-10 under the key
(scenario seed, CGM seed) at counter (lane, episode, site, index), the
streams the program documents (``ops/streams.py``), so a draw depends on
nothing but those words:

* ``SITE_CGM`` (0): the AR(1) normal of noise lattice point ``index``;
* ``SITE_MEAL`` .. ``SITE_MEAL + 4`` (1-5): the 18 uniforms of daily plan
  ``index`` (plan 0 at reset, plan ``day + 1`` once the clock enters day
  ``day`` since the start's midnight);
* ``SITE_INIT_BG`` (6): the three normals of the random initial state
  (indices 0 and 1);
* ``SITE_RESET`` (7): an ended episode's successor, index 0: its episode
  word and its start hour;
* ``SITE_START`` (8): the first episodes' start hours, index 0.

A normal is the first of a Box-Muller pair of a draw's first two words;
an hour is ``(word * 24) >> 32``.  Because the streams are stateless, a
new episode is drawn only where one ends, and any subset of lanes replays
alone.

Departures from simglucose v0.2.2, each the program's documented law:
Philox in place of NumPy's MT19937 (so the same seeds give other
episodes); a day's meal times by the inverse CDF of the truncated normal
and its amounts by the inverse CDF of the normal, where simglucose calls
``truncnorm.rvs`` and ``normal``; a random start hour per episode in place
of a seeded one; RK4 at one-minute steps in place of scipy's adaptive
``ode``; the one-hour CGM history as the reward window (the
risk-difference reward reads its last two entries).  Arithmetic is in
``dtype`` throughout.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.philox import philox4x32, uniform
from benchmark.reference.rollout import (
    _AMOUNT_MU,
    _AMOUNT_SIGMA,
    _CDF_LO,
    _CDF_SPAN,
    _MEAL_PROB,
    _TIME_MU,
    _TIME_SIGMA,
    EAT_RATE,
    MDL_SAMPLE_TIME,
    MINUTES_PER_DAY,
    _box_muller,
    _catmull,
    _johnson,
    _ndtri,
    _quantize,
    _rk4_minute,
    risk,
    sensor_pump,
)

SITE_CGM, SITE_MEAL, SITE_INIT_BG, SITE_RESET, SITE_START = 0, 1, 6, 7, 8
N_MEAL_SITES = 5
PLANES = ("obs", "reward", "terminated", "truncated", "bg", "risk", "meal", "insulin")
FINALS = ("final_obs", "final_bg", "final_risk")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """One vector env: sensor, pump and episode law."""

    horizon_steps: int
    sample_time: int = 3
    pacf: float = 0.7
    gamma: float = -0.5444
    lam: float = 15.9574
    delta: float = 1.6898
    xi: float = -5.47
    cgm_min: float = 39.0
    cgm_max: float = 600.0
    inc_basal: float = 0.05
    min_basal: float = 0.0
    max_basal: float = 30.0
    inc_bolus: float = 0.05
    min_bolus: float = 0.0
    max_bolus: float = 30.0
    bg_done_low: float = 70.0
    bg_done_high: float = 350.0


def env_config(sensor: dict, pump: dict, horizon_days: float) -> EnvConfig:
    """The env of a sensor and a pump record of the tables, episodes cut
    at ``horizon_days``."""
    fields = sensor_pump(sensor, pump)
    steps = int(horizon_days * 24 * 60 // fields["sample_time"])
    return EnvConfig(horizon_steps=steps, **fields)


def _draw(key: dict, site: int, index) -> tuple:
    return philox4x32(key["lane"], key["episode"], site, index, key["k0"], key["k1"])


def _normal(key: dict, site: int, index, dtype):
    w = _draw(key, site, index)
    return _box_muller(w[0], w[1], dtype)[0]


def _hour(word: torch.Tensor) -> torch.Tensor:
    return ((word * 24) >> 32).to(torch.int32)


def _column(values, dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64)[:, None].to(dtype)


def _meal_plan(key: dict, index, dtype) -> tuple:
    """Daily plan ``index``: the six slots' times ``[6, B]`` (minute of
    day, -1 when skipped) and grams, from the 18 uniforms of sites 1-5
    (site by site, four words each): occurrence, time, amount."""
    sites = torch.arange(SITE_MEAL, SITE_MEAL + N_MEAL_SITES)[:, None]
    w = philox4x32(key["lane"], key["episode"], sites, index, key["k0"], key["k1"])
    u = uniform(torch.stack(w, dim=1).reshape(4 * N_MEAL_SITES, -1), dtype)
    col = lambda v: _column(v, dtype)
    z_t = _ndtri(col(_CDF_LO) + u[6:12] * col(_CDF_SPAN))  # the truncated normal's inverse CDF
    t = torch.round(col(_TIME_MU) + col(_TIME_SIGMA) * z_t)
    g = torch.clamp(torch.round(col(_AMOUNT_MU) + col(_AMOUNT_SIGMA) * _ndtri(u[12:18])), min=0.0)
    occurs = u[:6] < col(_MEAL_PROB)
    return (torch.where(occurs, t, torch.full_like(t, -1.0)),
            torch.where(occurs, g, torch.zeros_like(g)))


def _sample(c: EnvConfig, s: dict, key: dict, bg):
    """One CGM sample of BG: the noise at lattice time ``(n + 1) *
    sample_time`` (Catmull-Rom through the four lattice points around it,
    a new point drawn where the sample needs it), clamped to the sensor's
    range.  Updates ``s`` and returns the sample."""
    tau = (s["n_samp"] + 1) * c.sample_time
    k = tau // MDL_SAMPLE_TIME
    u = (tau - k * MDL_SAMPLE_TIME).to(bg.dtype) / MDL_SAMPLE_TIME
    need = (k + 2) >= s["lat_next"]
    if bool(need.any()):
        e_new = c.pacf * (s["e"] + _normal(key, SITE_CGM, s["lat_next"], bg.dtype))
        s["e"] = torch.where(need, e_new, s["e"])
        lat = s["lat"]
        s["lat"] = [torch.where(need, n, o) for o, n in zip(lat, [*lat[1:], _johnson(c, e_new)])]
        s["lat_next"] = s["lat_next"] + need.to(torch.int32)
    s["n_samp"] = s["n_samp"] + 1
    s["last_CGM"] = torch.clamp(bg + _catmull(*s["lat"], u), c.cgm_min, c.cgm_max)
    return s["last_CGM"]


def _reset(c: EnvConfig, pt: dict, key: dict, start_min: torch.Tensor, dtype) -> tuple:
    """A fresh episode of every lane under ``key``: (state, reset
    result).  The initial state is x0 with x3, x4, x12 drawn as N(x0,
    0.1 x0); the noise lattice starts from three normals; the reset takes
    two CGM samples of the initial BG, the first one the reward window's
    history, the second one the observation."""
    x0 = pt["x0"]
    z = _normal(key, SITE_CGM, torch.arange(3)[:, None], dtype)  # lattice points 0-2
    w = _draw(key, SITE_INIT_BG, torch.arange(2)[:, None])
    pair = _box_muller(w[0], w[1], dtype)
    zi = (pair[0][0], pair[1][0], pair[0][1])  # index 0's pair, index 1's first
    xs = list(x0)
    for i, zz in zip((3, 4, 12), zi):
        xs[i] = x0[i] + torch.sqrt(0.1 * x0[i]) * zz
    e1 = c.pacf * (z[0] + z[1])
    e2 = c.pacf * (e1 + z[2])
    j0 = _johnson(c, z[0])
    B = start_min.shape[0]
    izero = torch.zeros(B, dtype=torch.int32, device=start_min.device)
    zero = torch.zeros_like(xs[0])
    times, grams = _meal_plan(key, 0, dtype)
    s = dict(xs=tuple(xs), times=times, grams=grams,
             plan_day=torch.where(start_min == 0, izero - 1, izero), start_min=start_min,
             t=izero, steps=izero, planned=zero, last_CHO=zero,
             eating=torch.zeros(B, dtype=torch.bool, device=start_min.device),
             last_Qsto=xs[0] + xs[1], foodtaken=zero, e=e2,
             lat=[j0, j0, _johnson(c, e1), _johnson(c, e2)], lat_next=izero + 3, n_samp=izero,
             key=key)
    bg0 = xs[12] / pt["Vg"]
    s["prev_cgm"] = _sample(c, s, key, bg0)  # the reward window's history
    obs = _sample(c, s, key, bg0)
    return s, dict(obs=obs, bg=bg0, risk=risk(bg0), meal=zero, insulin=zero)


def _select(mask, new, old):
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask, new, old)


def _step(c: EnvConfig, pt: dict, s: dict, action, dtype) -> tuple:
    """One ``step``: the pump, ``sample_time`` minutes, the step's means,
    reward, termination and truncation.  Returns (state, step result)."""
    st = c.sample_time
    insulin = (_quantize(action, c.inc_basal, c.min_basal, c.max_basal)
               + _quantize(torch.zeros_like(action), c.inc_bolus, c.min_bolus, c.max_bolus))
    ins_rate = insulin * 6000.0 / pt["BW"]
    key, xs = s["key"], s["xs"]
    zero = torch.zeros_like(action)
    cho = ins = bg_acc = cgm_acc = zero
    for m in range(st):
        clock = s["start_min"] + s["t"]
        day = torch.div(clock, MINUTES_PER_DAY, rounding_mode="floor")
        regen = day > s["plan_day"]
        if bool(regen.any()):  # a midnight: the day's plan
            nt, ng = _meal_plan(key, day.to(torch.int64) + 1, dtype)
            s["times"] = torch.where(regen, nt, s["times"])
            s["grams"] = torch.where(regen, ng, s["grams"])
            s["plan_day"] = torch.maximum(s["plan_day"], day)
        mod = (clock - day * MINUTES_PER_DAY).to(dtype)
        hit = s["times"] == mod
        first = torch.argmax(hit.to(torch.uint8), dim=0, keepdim=True)  # the first slot
        meal = torch.where(hit.any(dim=0), torch.gather(s["grams"], 0, first)[0], zero)
        planned = s["planned"] + meal
        to_eat = torch.where(planned > 0, torch.clamp(planned, max=EAT_RATE), zero)
        s["planned"] = torch.clamp(planned - to_eat, min=0.0)
        starts = (to_eat > 0) & (s["last_CHO"] <= 0)
        s["last_Qsto"] = torch.where(starts, xs[0] + xs[1], s["last_Qsto"])
        food = torch.where(starts, zero, s["foodtaken"])
        eating = starts | s["eating"]
        s["foodtaken"] = torch.where(eating, food + to_eat, food)
        s["eating"] = eating & ~((to_eat <= 0) & (s["last_CHO"] > 0))
        s["last_CHO"] = to_eat
        xs = _rk4_minute(pt, xs, to_eat * 1000.0, ins_rate,
                         s["last_Qsto"] + s["foodtaken"] * 1000.0)
        s["t"] = s["t"] + 1
        bg = xs[12] / pt["Vg"]
        cgm = _sample(c, s, key, bg) if m == st - 1 else s["last_CGM"]
        cho = cho + meal / st
        ins = ins + insulin / st
        bg_acc = bg_acc + bg / st
        cgm_acc = cgm_acc + cgm / st
    s["xs"] = xs
    reward = risk(s["prev_cgm"]) - risk(cgm_acc)
    s["prev_cgm"] = cgm_acc
    s["steps"] = s["steps"] + 1
    done = (bg_acc < c.bg_done_low) | (bg_acc > c.bg_done_high)
    trunc = s["steps"] >= c.horizon_steps
    return s, dict(obs=cgm_acc, reward=reward, terminated=done, truncated=trunc, bg=bg_acc,
                   risk=risk(bg_acc), meal=cho, insulin=ins)


def run(c: EnvConfig, pt: dict, seed: int, lanes: torch.Tensor, actions: torch.Tensor,
        dtype=torch.float32) -> dict:
    """``reset(seed=seed)`` and then ``step(actions[t])`` for each row
    ``t`` of the ``[T, B]`` actions (U/min of basal), for lanes ``lanes``
    of the vector env (patients ``pt``, columns of
    :func:`benchmark.reference.tables.patients` in ``dtype``).

    Returns the ``[T, B]`` planes :data:`PLANES` as the agent reads them
    after each step (where an episode ended, the new episode's reset
    observation, BG and risk, and meal and insulin 0) and :data:`FINALS`,
    the terminal step's observation, BG and risk (meaningful where it
    ended), with the reset's ``obs0`` and ``bg0`` ``[B]``.  On the card,
    float32 products stay float32 (no TF32)."""
    if lanes.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    key = dict(k0=int(seed) & 0xFFFFFFFF, k1=0, lane=lanes.to(torch.int64),
               episode=torch.zeros_like(lanes, dtype=torch.int64))
    start = _hour(_draw(key, SITE_START, 0)[0]) * 60
    s, r0 = _reset(c, pt, key, start, dtype)
    out = {k: [] for k in PLANES + FINALS}
    actions = actions.to(dtype)
    for a in actions:
        s, r = _step(c, pt, s, a, dtype)
        ended = r["terminated"] | r["truncated"]
        for k, f in zip(FINALS, ("obs", "bg", "risk")):
            out[k].append(r[f])
        if bool(ended.any()):  # SAME_STEP: the successor episode at once
            old = s.pop("key")
            w = _draw(old, SITE_RESET, 0)
            fresh, fr = _reset(c, pt, dict(old, episode=w[0]), _hour(w[1]) * 60, dtype)
            fresh.pop("key")
            s = _select(ended, fresh, s)
            s["key"] = dict(old, episode=torch.where(ended, w[0], old["episode"]))
            r = dict(r, **{k: torch.where(ended, fr[k], r[k]) for k in fr})
        for k in PLANES:
            out[k].append(r[k])
    res = {k: torch.stack(v) for k, v in out.items()}
    res.update(obs0=r0["obs"], bg0=r0["bg"])
    return res
