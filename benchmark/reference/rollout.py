"""The closed-loop rollout, written out plainly: per patient and env step
the controller (PID, basal-bolus or the Gaussian MLP policy), the random
meal scenario and the eating state machine, ``sample_time`` RK4 minutes of
the UVA/Padova 2008 ODE (Dalla Man et al., IEEE TBME 2007; simglucose
v0.2.2's ``T1DPatient``), the CGM noise (AR(1) on a 15-minute lattice,
Johnson-SU, Catmull-Rom between lattice points), the Insulet pump's
quantization, the risk-difference reward, termination and auto-reset.

Every lane draws from Philox-4x32-10 with key (scenario seed, CGM seed)
and counter (global lane, global step, draw site, 0), the program's
documented streams, so the two compute the same closed loop from the same
keys.  Lanes are independent: a sample of lanes, each with its own key,
runs as one batch.  Arithmetic is in ``dtype`` throughout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.philox import philox4x32, uniform

MDL_SAMPLE_TIME = 15  # min between noise lattice points
MINUTES_PER_DAY = 1440
EAT_RATE = 5.0  # g/min
LOG_2PI = math.log(2.0 * math.pi)
# Philox draw sites (counter word 2)
SITE_CGM, SITE_MEAL, SITE_RESET, SITE_INIT_MEAL, SITE_INIT_RESET, SITE_ACTION = 0, 1, 6, 8, 13, 15

# simglucose's random scenario (scenario_gen.py): six meal slots
_MEAL_PROB = (0.95, 0.3, 0.95, 0.3, 0.95, 0.3)
_TIME_LB = tuple(x * 60.0 for x in (5, 9, 10, 14, 16, 20))
_TIME_UB = tuple(x * 60.0 for x in (9, 10, 14, 16, 20, 23))
_TIME_MU = tuple(x * 60.0 for x in (7, 9.5, 12, 15, 18, 21.5))
_TIME_SIGMA = (60.0, 30.0, 60.0, 30.0, 60.0, 30.0)
_AMOUNT_MU = (45.0, 10.0, 70.0, 10.0, 80.0, 10.0)
_AMOUNT_SIGMA = (10.0, 5.0, 10.0, 5.0, 10.0, 5.0)


def _cdf(s: int, x: float) -> float:
    return 0.5 * (1.0 + math.erf((x - _TIME_MU[s]) / _TIME_SIGMA[s] / math.sqrt(2.0)))


_CDF_LO = tuple(_cdf(s, _TIME_LB[s]) for s in range(6))
_CDF_SPAN = tuple(_cdf(s, _TIME_UB[s]) - _cdf(s, _TIME_LB[s]) for s in range(6))
_FULL_NDTRI = tuple(min(_cdf(s, _TIME_LB[s]), 1.0 - _cdf(s, _TIME_UB[s])) < 0.0227
                    for s in range(6))
# Acklam's inverse normal CDF
_NA = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
       1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_NB = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
       6.680131188771972e01, -1.328068155288572e01)
_NC = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
       -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_ND = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
       3.754408661907416e00)


@dataclasses.dataclass(frozen=True)
class Config:
    """One closed loop: sensor, pump, controller and episode law."""

    n_steps: int
    controller: str  # 'pid' | 'bb' | 'nn'
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
    pid_p: float = -1e-4
    pid_i: float = -1e-7
    pid_d: float = 0.0
    pid_target: float = 140.0
    bb_target: float = 140.0
    bg_done_low: float = 70.0
    bg_done_high: float = 350.0
    random_init_bg: bool = True
    autoreset: bool = True
    fixed_start_min: int = -1  # < 0: a random start hour
    action_scale: float = 0.2  # the policy's sigmoid decoder, U/min


def sensor_pump(sensor: dict, pump: dict) -> dict:
    """Config fields of a sensor and a pump record of the tables."""
    return dict(sample_time=int(sensor["sample_time"]), pacf=float(sensor["PACF"]),
                gamma=float(sensor["gamma"]), lam=float(sensor["lambda"]),
                delta=float(sensor["delta"]), xi=float(sensor["xi"]),
                cgm_min=float(sensor["min"]), cgm_max=float(sensor["max"]),
                **{k: float(pump[k]) for k in ("inc_basal", "min_basal", "max_basal", "inc_bolus",
                                              "min_bolus", "max_bolus")})


def _words(key, lane, step, site: int, n_quads: int) -> list:
    out = []
    for q in range(n_quads):
        out += philox4x32(lane, step, site + q, 0, *key)
    return out


def _box_muller(w1, w2, dtype):
    r = torch.sqrt(-2.0 * torch.log(uniform(w1, dtype)))
    th = (2.0 * math.pi) * uniform(w2, dtype)
    return r * torch.cos(th), r * torch.sin(th)


def _ndtri_central(p):
    q = p - 0.5
    r = q * q
    num = ((((_NA[0] * r + _NA[1]) * r + _NA[2]) * r + _NA[3]) * r + _NA[4]) * r + _NA[5]
    den = (((((_NB[0] * r + _NB[1]) * r + _NB[2]) * r + _NB[3]) * r + _NB[4]) * r) + 1.0
    return num * q / den


def _ndtri_tail(q):
    num = ((((_NC[0] * q + _NC[1]) * q + _NC[2]) * q + _NC[3]) * q + _NC[4]) * q + _NC[5]
    den = (((_ND[0] * q + _ND[1]) * q + _ND[2]) * q + _ND[3]) * q + 1.0
    return num, den


def _ndtri(p):
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    num_l, den_l = _ndtri_tail(torch.sqrt(-2.0 * torch.log(p)))
    num_u, den_u = _ndtri_tail(torch.sqrt(-2.0 * torch.log(1.0 - p)))
    return torch.where(p < 0.02425, num_l / den_l,
                       torch.where(p > 1.0 - 0.02425, -num_u / den_u, _ndtri_central(p)))


def _johnson(c: Config, x):
    ez = torch.exp((x - c.gamma) / c.delta)
    return c.xi + c.lam * 0.5 * (ez - 1.0 / ez)


def _catmull(l0, l1, l2, l3, u):
    m1, m2 = 0.5 * (l2 - l0), 0.5 * (l3 - l1)
    u2 = u * u
    u3 = u2 * u
    return ((2.0 * u3 - 3.0 * u2 + 1.0) * l1 + (u3 - 2.0 * u2 + u) * m1
            + (-2.0 * u3 + 3.0 * u2) * l2 + (u3 - u2) * m2)


def _quantize(amount, inc, lo, hi):
    """The pump delivers whole increments of ``inc`` U per hour's 6000ths."""
    return torch.clamp(torch.round(amount * 6000.0 / inc) * inc / 6000.0, lo, hi)


def risk(bg):
    """Magni's risk of a BG (mg/dL): 10 * (1.509 (ln(BG)^1.084 - 5.381))^2."""
    f = 1.509 * (torch.pow(torch.log(torch.clamp(bg, min=1.0)), 1.084) - 5.381)
    return 10.0 * f * f


def _meal_plan(w, dtype):
    """One day's six meal slots from 18 words: times (min of day, -1 when
    skipped) and grams."""
    z = []
    for i in range(3):
        z += _box_muller(w[2 * i], w[2 * i + 1], dtype)
    times, amounts = [], []
    for s in range(6):
        u_occ, u_t = uniform(w[6 + 2 * s], dtype), uniform(w[7 + 2 * s], dtype)
        inv = _ndtri if _FULL_NDTRI[s] else _ndtri_central
        t = torch.round(_TIME_MU[s] + _TIME_SIGMA[s] * inv(_CDF_LO[s] + u_t * _CDF_SPAN[s]))
        amt = torch.clamp(torch.round(_AMOUNT_MU[s] + _AMOUNT_SIGMA[s] * z[s]), min=0.0)
        occurs = u_occ < _MEAL_PROB[s]
        times.append(torch.where(occurs, t, torch.full_like(t, -1.0)))
        amounts.append(torch.where(occurs, amt, torch.zeros_like(amt)))
    return times, amounts


def _reset(c: Config, w, x0, Vg, dtype):
    """A fresh episode from 7 words: ODE state, AR(1) state and lattice,
    start minute, first CGM."""
    xs = list(x0)
    z = [*_box_muller(w[0], w[1], dtype), *_box_muller(w[2], w[3], dtype),
         *_box_muller(w[4], w[5], dtype)]
    lat_z = z[3:6] if c.random_init_bg else z[0:3]
    if c.random_init_bg:
        for idx, zz in zip((3, 4, 12), z[0:3]):
            xs[idx] = x0[idx] + torch.sqrt(0.1 * x0[idx]) * zz
    e0 = lat_z[0]
    e1 = c.pacf * (e0 + lat_z[1])
    e2 = c.pacf * (e1 + lat_z[2])
    j0 = _johnson(c, e0)
    lat = (j0, j0, _johnson(c, e1), _johnson(c, e2))
    if c.fixed_start_min >= 0:
        start = torch.full(x0[0].shape, c.fixed_start_min, dtype=torch.int32, device=x0[0].device)
    else:
        start = torch.floor(uniform(w[6]) * 24.0).to(torch.int32) * 60
    cgm0 = torch.clamp(xs[12] / Vg + lat[1], c.cgm_min, c.cgm_max)
    return dict(xs=tuple(xs), e=e2, lat=lat, start=start, cgm0=cgm0)


def _rhs(p, xs, d_mg, ins_rate, Dbar):
    """dx/dt of the 13 UVA/Padova states."""
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12 = xs
    qsto = x0 + x1
    meal_on = Dbar > 0
    sD = torch.where(meal_on, Dbar, torch.ones_like(Dbar))
    aa = 5.0 / 2.0 / (1.0 - p["b"]) / sD
    cc = 5.0 / 2.0 / p["d"] / sD
    kgut = torch.where(meal_on, p["kmin"] + (p["kmax"] - p["kmin"]) / 2.0 * (
        torch.tanh(aa * (qsto - p["b"] * sD)) - torch.tanh(cc * (qsto - p["d"] * sD)) + 2.0),
        p["kmax"])
    zero = torch.zeros_like(x3)
    dx0 = -p["kmax"] * x0 + d_mg
    dx1 = p["kmax"] * x0 - x1 * kgut
    dx2 = kgut * x1 - p["kabs"] * x2
    Rat = p["f"] * p["kabs"] * x2 / p["BW"]
    EGPt = p["kp1"] - p["kp2"] * x3 - p["kp3"] * x8
    Et = torch.where(x3 > p["ke2"], p["ke1"] * (x3 - p["ke2"]), zero)
    dx3 = torch.clamp(EGPt, min=0.0) + Rat - p["Fsnc"] - Et - p["k1"] * x3 + p["k2"] * x4
    dx3 = torch.where(x3 >= 0, dx3, zero)
    Uidt = (p["Vm0"] + p["Vmx"] * x6) * x4 / (p["Km0"] + x4)
    dx4 = torch.where(x4 >= 0, -Uidt + p["k1"] * x3 - p["k2"] * x4, zero)
    dx5 = -(p["m2"] + p["m4"]) * x5 + p["m1"] * x9 + p["ka1"] * x10 + p["ka2"] * x11
    It = x5 / p["Vi"]
    dx5 = torch.where(x5 >= 0, dx5, zero)
    dx6 = -p["p2u"] * x6 + p["p2u"] * (It - p["Ib"])
    dx7 = -p["ki"] * (x7 - It)
    dx8 = -p["ki"] * (x8 - x7)
    dx9 = torch.where(x9 >= 0, -(p["m1"] + p["m30"]) * x9 + p["m2"] * x5, zero)
    dx10 = torch.where(x10 >= 0, ins_rate - (p["ka1"] + p["kd"]) * x10, zero)
    dx11 = torch.where(x11 >= 0, p["kd"] * x10 - p["ka2"] * x11, zero)
    dx12 = torch.where(x12 >= 0, -p["ksc"] * x12 + p["ksc"] * x3, zero)
    return (dx0, dx1, dx2, dx3, dx4, dx5, dx6, dx7, dx8, dx9, dx10, dx11, dx12)


def _rk4_minute(p, xs, d_mg, ins_rate, Dbar):
    f = lambda ys: _rhs(p, ys, d_mg, ins_rate, Dbar)
    k1 = f(xs)
    k2 = f(tuple(y + 0.5 * k for y, k in zip(xs, k1)))
    k3 = f(tuple(y + 0.5 * k for y, k in zip(xs, k2)))
    k4 = f(tuple(y + k for y, k in zip(xs, k3)))
    return tuple(x + (1.0 / 6.0) * (a + 2.0 * b + 2.0 * c_ + d)
                 for x, a, b, c_, d in zip(xs, k1, k2, k3, k4))


def _features(basal, ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob):
    """The policy's seven observation features, ``[B, 7]``."""
    b = basal + 1e-8
    return torch.stack([
        ctrl_prev * 0.0025, (ctrl_prev - 140.0) * 0.01, torch.tanh(ins_prev * (1.0 / (3.0 * b))),
        torch.tanh(prev_cho * 0.1), torch.tanh((ctrl_prev - ctrl_pprev) * 0.1),
        torch.tanh(iob * (1.0 / (120.0 * b))), torch.tanh(20.0 * basal)], dim=-1)


def mlp(policy: dict, obs):
    """(mu, value) of the relu 7-H-H policy and value heads at ``obs``
    ``[..., 7]``."""
    h = torch.relu(obs @ policy["w1"] + policy["b1"])
    h = torch.relu(h @ policy["w2"] + policy["b2"])
    mu = (h @ policy["w_mu"])[..., 0] + policy["b_mu"][0]
    return mu, (h @ policy["w_v"])[..., 0] + policy["b_v"][0]


def rollout(c: Config, pt: dict, key, lanes: torch.Tensor, step_offset: int = 0, state=None,
            policy=None, dtype=torch.float32) -> tuple:
    """``c.n_steps`` closed-loop steps of the patients ``pt`` (columns of
    :func:`benchmark.reference.tables.patients` in ``dtype``), lane ``i``
    being global lane ``lanes[i]`` under key ``key`` (two ints or two
    ``[B]`` int64 tensors).  ``state`` continues an earlier call's; None
    draws fresh episodes.  ``policy`` (leaves in ``dtype``) drives the
    ``'nn'`` controller with sampled actions.

    Returns (out, state): ``out`` holds the ``[T, B]`` planes CGM BG reward
    done CHO insulin, the reset row BG0 CGM0 (on a fresh start), and for
    ``'nn'`` the learner rows ``obs`` ``[T, B, 7]``, ``value``, ``raw``,
    ``logp`` ``[T, B]`` and ``tail_value`` ``[B]``."""
    dev = lanes.device
    B = lanes.shape[0]
    st = c.sample_time
    inv_st = 1.0 / st
    zero = torch.zeros(B, dtype=dtype, device=dev)
    izero = torch.zeros(B, dtype=torch.int32, device=dev)
    x0, Vg, basal = pt["x0"], pt["Vg"], pt["basal"]
    clip_cgm = lambda v: torch.clamp(v, c.cgm_min, c.cgm_max)
    out = {}
    if state is None:
        rv = _reset(c, _words(key, lanes, step_offset, SITE_INIT_RESET, 2), x0, Vg, dtype)
        xs = rv["xs"]
        cgm0 = rv["cgm0"]
        meal_t, meal_a = _meal_plan(_words(key, lanes, step_offset, SITE_INIT_MEAL, 5), dtype)
        s = dict(planned=zero, last_CHO=zero, eating=torch.zeros(B, dtype=torch.bool, device=dev),
                 last_Qsto=xs[0] + xs[1], foodtaken=zero, last_CGM=cgm0, e=rv["e"],
                 lat=list(rv["lat"]), pid_integ=zero, pid_prev=zero, prev_risk=risk(cgm0),
                 prev_cho=zero, ctrl_prev=cgm0, ins_prev=zero, ctrl_pprev=cgm0, iob=zero,
                 t_min=izero, start_min=rv["start"], day=izero,
                 lat_next=torch.full_like(izero, 3), n_samp=izero)
        out["BG0"], out["CGM0"] = xs[12] / Vg, cgm0
    else:
        xs, meal_t, meal_a, s = state["xs"], state["meal_t"], state["meal_a"], dict(state["s"])
    planes = {k: [] for k in ("CGM", "BG", "reward", "done", "CHO", "insulin")}
    nn = c.controller == "nn"
    if nn:
        log_std = policy["log_std"][0]
        sigma, inv_sigma = torch.exp(log_std), torch.exp(-log_std)
        rows = {k: [] for k in ("obs", "value", "raw", "logp")}
    for t in range(c.n_steps):
        gstep = step_offset + t
        obs = s["ctrl_prev"]
        if nn:
            feats = _features(basal, obs, s["ins_prev"], s["prev_cho"], s["ctrl_pprev"], s["iob"])
            mu, v = mlp(policy, feats)
            wz = philox4x32(lanes, gstep, SITE_ACTION, 0, *key)
            raw = mu + sigma * _box_muller(wz[0], wz[1], dtype)[0]
            z = (raw - mu) * inv_sigma
            for k, val in zip(rows, (feats, v, raw, -0.5 * z * z - log_std - 0.5 * LOG_2PI)):
                rows[k].append(val)
            insulin = _quantize(c.action_scale / (1.0 + torch.exp(-raw)), c.inc_basal,
                                c.min_basal, c.max_basal)
            s["iob"] = s["iob"] * math.exp(-st / 100.0) + insulin * float(st)
        elif c.controller == "pid":
            u = c.pid_p * (obs - c.pid_target) + c.pid_i * s["pid_integ"] + c.pid_d * (
                obs - s["pid_prev"]) / st
            s["pid_integ"] = s["pid_integ"] + (obs - c.pid_target) * st
            s["pid_prev"] = obs
            insulin = _quantize(u, c.inc_basal, c.min_basal, c.max_basal)
        else:  # basal-bolus: basal, plus a bolus for an announced meal
            meal_ann = s["prev_cho"]
            bolus = (meal_ann * st) / pt["CR"] + (obs > 150.0).to(dtype) * (
                obs - c.bb_target) / pt["CF"]
            bolus = torch.where(meal_ann > 0, bolus / st, zero)
            insulin = (_quantize(basal, c.inc_basal, c.min_basal, c.max_basal)
                       + _quantize(bolus, c.inc_bolus, c.min_bolus, c.max_bolus))
        # a new day's meal plan at each lane's midnight
        day_end = (s["start_min"] + s["t_min"] + (st - 1)) // MINUTES_PER_DAY
        regen = day_end > s["day"]
        if bool(regen.any()):
            nt, na = _meal_plan(_words(key, lanes, gstep, SITE_MEAL, 5), dtype)
            meal_t = [torch.where(regen, n, o) for n, o in zip(nt, meal_t)]
            meal_a = [torch.where(regen, n, o) for n, o in zip(na, meal_a)]
        s["day"] = torch.maximum(s["day"], day_end)
        cho_acc = bg_acc = cgm_acc = zero
        ins_rate = insulin * 6000.0 / pt["BW"]
        for m in range(st):
            mod = ((s["start_min"] + s["t_min"]) % MINUTES_PER_DAY).to(dtype)
            meal, taken = zero, torch.zeros(B, dtype=torch.bool, device=dev)
            for k in range(6):
                hit = (meal_t[k] == mod) & ~taken
                meal = meal + hit.to(dtype) * meal_a[k]
                taken = taken | hit
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
            s["t_min"] = s["t_min"] + 1
            bg_m = xs[12] / Vg
            if m == st - 1:  # a CGM sample
                tau = (s["n_samp"] + 1) * st
                k = tau // MDL_SAMPLE_TIME
                u = (tau - k * MDL_SAMPLE_TIME).to(dtype) / MDL_SAMPLE_TIME
                need = (k + 2) >= s["lat_next"]
                wz = philox4x32(lanes, gstep, SITE_CGM, 0, *key)
                e_new = c.pacf * (s["e"] + _box_muller(wz[0], wz[1], dtype)[0])
                eps = _johnson(c, e_new)
                s["e"] = torch.where(need, e_new, s["e"])
                lat = s["lat"]
                s["lat"] = [torch.where(need, n, o) for o, n in zip(lat, [*lat[1:], eps])]
                s["lat_next"] = s["lat_next"] + need.to(torch.int32)
                s["last_CGM"] = clip_cgm(bg_m + _catmull(*s["lat"], u))
                s["n_samp"] = s["n_samp"] + 1
            cho_acc = cho_acc + meal * inv_st
            bg_acc = bg_acc + bg_m * inv_st
            cgm_acc = cgm_acc + s["last_CGM"] * inv_st
        risk_now = risk(cgm_acc)
        reward = s["prev_risk"] - risk_now
        done = (bg_acc < c.bg_done_low) | (bg_acc > c.bg_done_high)
        for k, v in zip(planes, (cgm_acc, bg_acc, reward, done, cho_acc, insulin)):
            planes[k].append(v)
        s.update(prev_risk=risk_now, prev_cho=cho_acc, ctrl_pprev=s["ctrl_prev"],
                 ctrl_prev=cgm_acc, ins_prev=insulin)
        if c.autoreset and bool(done.any()):
            rv = _reset(c, _words(key, lanes, gstep, SITE_RESET, 2), x0, Vg, dtype)
            sel = lambda new, old: torch.where(done, new, old)
            xs = tuple(sel(n, o) for n, o in zip(rv["xs"], xs))
            for name in ("planned", "last_CHO", "foodtaken", "pid_integ", "pid_prev",
                         "prev_cho", "ins_prev", "iob"):
                s[name] = sel(zero, s[name])
            s["eating"] = s["eating"] & ~done
            s["last_Qsto"] = sel(rv["xs"][0] + rv["xs"][1], s["last_Qsto"])
            cgm0 = rv["cgm0"]
            for name in ("last_CGM", "ctrl_prev", "ctrl_pprev"):
                s[name] = sel(cgm0, s[name])
            s["e"] = sel(rv["e"], s["e"])
            s["lat"] = [sel(n, o) for n, o in zip(rv["lat"], s["lat"])]
            s["prev_risk"] = sel(risk(cgm0), s["prev_risk"])
            for name in ("t_min", "day", "n_samp"):
                s[name] = sel(izero, s[name])
            s["start_min"] = sel(rv["start"], s["start_min"])
            s["lat_next"] = sel(torch.full_like(izero, 3), s["lat_next"])
    out.update({k: torch.stack(v) for k, v in planes.items()})
    if nn:
        out.update({k: torch.stack(v) for k, v in rows.items()})
        tail = _features(basal, s["ctrl_prev"], s["ins_prev"], s["prev_cho"], s["ctrl_pprev"],
                         s["iob"])
        out["tail_value"] = mlp(policy, tail)[1]
    return out, dict(xs=xs, meal_t=meal_t, meal_a=meal_a, s=s)
