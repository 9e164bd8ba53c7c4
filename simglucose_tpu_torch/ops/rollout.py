"""The closed-loop cohort rollout, K1a and K1b: host side, plain version,
wrapper.

Counterpart of ``simglucose_tpu/ops/pallas_rollout.py``.  Per patient and
env step the rollout runs the controller, the meal scenario, the eating
state machine, ``sample_time`` RK4 minutes of the UVA/Padova ODE, the CGM
noise chain (AR(1) on a 15-min lattice -> Johnson-SU -> Catmull-Rom),
reward, termination and auto-reset.  K1a is the PID, basal-bolus and
constant-basal controllers; K1b the ``'nn'`` controller, the Gaussian MLP
policy of :mod:`simglucose_tpu_torch.rl.policy` run inside the rollout,
which also writes the PPO learner's rows (``nn_emit_learner_rows``) or the
controller's observation planes.

* :func:`rollout_reference` is the plain PyTorch version of the whole
  kernel body, vectorised over patients.  CPU tests hold it against the JAX
  package; ``chip_smoke.py`` holds the CUDA kernels against it on the card.
* :func:`rollout` is the wrapper: CPU tensors go to the plain version, CUDA
  tensors to the kernels in ``csrc/rollout.cu`` (built by
  :mod:`simglucose_tpu_torch.ops.build`), anything else raises.  Each kernel
  launch adds one to ``LAUNCHES["rollout"]`` (K1a) or
  ``LAUNCHES["rollout_nn"]`` (K1b).

Randomness is Philox-4x32-10 (:mod:`simglucose_tpu_torch.ops.philox`) with
key (scenario seed, cgm seed) and counter (global lane, global step, draw
site, 0), so a shard of a batch (:func:`make_sharded_rollout`, one rank's
lanes) and a horizon cut into calls draw what the whole run draws.  The
laws are the JAX kernel's; its TPU cost tricks are gone: the meal plan is
redrawn exactly at each lane's midnight, reset values are drawn fresh on
each ``done``, and every AR(1) advance draws its own normal.
Stochastic configs therefore agree with JAX by law, not by bit.

Public layouts are the JAX package's: packed parameters ``[50, rows, 128]``
(the same memory as ``[50, B]``), trajectories ``[T, B]``, persistent state
``[64, rows, 128]`` float32 + ``[7, rows, 128]`` int32 with the plane map
below.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from simglucose_tpu_torch.core.types import PatientParams
from simglucose_tpu_torch.models.uva_padova import EAT_RATE, model_rhs_parts
from simglucose_tpu_torch.ops.philox import philox4x32, uniform
from simglucose_tpu_torch.rl.policy import DECODERS, LOG_2PI, iob_decay, iob_step
from simglucose_tpu_torch.utils.profiling import span

LANES = 128
MDL_SAMPLE_TIME = 15  # noise lattice spacing, min
MINUTES_PER_DAY = 1440

# Meal-slot law (reference scenario_gen.py:36-44)
_MEAL_PROB = (0.95, 0.3, 0.95, 0.3, 0.95, 0.3)
_TIME_LB = tuple(x * 60.0 for x in (5, 9, 10, 14, 16, 20))
_TIME_UB = tuple(x * 60.0 for x in (9, 10, 14, 16, 20, 23))
_TIME_MU = tuple(x * 60.0 for x in (7, 9.5, 12, 15, 18, 21.5))
_TIME_SIGMA = (60.0, 30.0, 60.0, 30.0, 60.0, 30.0)
_AMOUNT_MU = (45.0, 10.0, 70.0, 10.0, 80.0, 10.0)
_AMOUNT_SIGMA = (10.0, 5.0, 10.0, 5.0, 10.0, 5.0)


def _cdf(s: int, bound: float) -> float:
    return 0.5 * (1.0 + math.erf((bound - _TIME_MU[s]) / _TIME_SIGMA[s] / math.sqrt(2.0)))


# truncnorm meal times: the CDF window of each slot, computed in double on
# the host (the kernel receives them as float32, as the JAX kernel's
# Python-float constants are rounded); slots whose window reaches past
# +/-2 sigma need the full 3-branch inverse CDF
_MEAL_CDF_LO = tuple(_cdf(s, _TIME_LB[s]) for s in range(6))
_MEAL_CDF_SPAN = tuple(_cdf(s, _TIME_UB[s]) - _cdf(s, _TIME_LB[s]) for s in range(6))
_MEAL_FULL_NDTRI = tuple(
    min(_cdf(s, _TIME_LB[s]), 1.0 - _cdf(s, _TIME_UB[s])) < 0.0227 for s in range(6)
)

# packed per-patient planes: the 34 non-x0 PatientParams fields, x0_1..13,
# then basal, CR, CF
_PARAM_FIELDS = [f for f in PatientParams._fields if f != "x0"]
NP_PLANES = len(_PARAM_FIELDS) + 13 + 3

# Persistent state planes, the JAX kernel's map (pallas_rollout.py:537-566):
#   0..12 ODE states  13 planned_meal  14 last_CHO  15 is_eating
#   16 last_Qsto  17 foodtaken  18 last_CGM  19 e (AR(1))  20..23 lattice
#   24..29 meal_times  30..35 meal_amounts  36 pid_integ  37 pid_prev
#   38 risk(prev CGM) (not the CGM itself)  39 prev_CHO  40 ctrl_prev
#   61 ins_prev  62 ctrl_pprev  63 iob
# Planes 41..60 (the JAX kernel's cached reset draws) and int plane 6 are
# unused here — resets draw fresh values — and are written as 0.
NS_F = 64
#   int planes: 0 t_min  1 start_min  2 day  3 seg  4 lattice_next
#   5 sample_count
NS_I = 7

# Philox draw sites (counter word 2); each site yields four 32-bit words
SITE_CGM = 0  # the AR(1) normal of one CGM sample
SITE_MEAL = 1  # 1..5: a day's meal plan (18 words)
SITE_RESET = 6  # 6..7: auto-reset values (7 words)
SITE_INIT_MEAL = 8  # 8..12: the first episode's meal plan
SITE_INIT_RESET = 13  # 13..14: the first episode's reset values
SITE_ACTION = 15  # the 'nn' controller's Gaussian action noise, one per step

CONTROLLERS = ("pid", "bb", "const", "nn")

# launches of the CUDA kernels made through :func:`rollout`
LAUNCHES = {"rollout": 0, "rollout_nn": 0}


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """The fields of the JAX ``PallasRolloutConfig`` that change results.

    TPU tiling (``block_rows``, ``t_chunk``), the TPU generator (``prng``),
    its redraw cadence (``regen_every``) and ``persistent_state`` (the port
    always returns the final state) have no counterpart, nor has
    ``nn_batched_mlp`` (a TPU layout of the same values)."""

    sample_time: int = 3
    n_steps: int = 256  # env steps per call
    # sensor (Dexcom row of the sensor table)
    pacf: float = 0.7
    gamma: float = -0.5444
    lam: float = 15.9574
    delta: float = 1.6898
    xi: float = -5.47
    cgm_min: float = 39.0
    cgm_max: float = 600.0
    # pump (Insulet row of the pump table)
    inc_basal: float = 0.05
    min_basal: float = 0.0
    max_basal: float = 30.0
    inc_bolus: float = 0.05
    min_bolus: float = 0.0
    max_bolus: float = 30.0
    controller: str = "pid"  # 'pid' | 'bb' | 'const' | 'nn'
    # the 'nn' controller (K1b): relu MLP 7 -> nn_hidden -> nn_hidden ->
    # (mu, value); weights from pack_policy_weights
    nn_hidden: int = 64
    # 'sigmoid': basal = sigmoid(raw) * nn_action_scale [* patient basal];
    # 'residual_bb': insulin = BB command * exp(nn_action_scale * tanh(raw))
    nn_action_scale: float = 0.2
    nn_scale_by_basal: bool = False
    # False: the policy's mean action (evaluation); the env stays stochastic
    nn_sample_actions: bool = True
    nn_decoder: str = "sigmoid"
    # True: write the learner's [10, T*B] rows (features, value, raw action,
    # behaviour log-prob) and the tail value instead of the observation
    # planes and the tail observation
    nn_emit_learner_rows: bool = False
    pid_p: float = -1e-4
    pid_i: float = -1e-7
    pid_d: float = 0.0
    pid_target: float = 140.0
    bb_target: float = 140.0
    const_basal: float = 0.0
    reward_kind: str = "risk_diff"  # 'risk_diff' | 'neg_risk'
    bg_done_low: float = 70.0
    bg_done_high: float = 350.0
    random_init_bg: bool = True
    # autoreset=False: fixed horizon through excursions (batch_sim semantics)
    autoreset: bool = True
    # >= 0: every lane starts at this minute of day; < 0: random start hour
    fixed_start_min: int = -1
    # deterministic=True: no noise, no random meals, no resets, x0 init;
    # det_meal_* give a static schedule (episode minute -> grams)
    deterministic: bool = False
    det_meal_times: tuple = ()
    det_meal_amounts: tuple = ()
    # 'random' daily meal plans, or the static det_meal_* schedule with the
    # stochastic sensor/init/reset laws still on (custom scenarios)
    scenario_kind: str = "random"
    # CGM noise from caller-supplied planes: 2 reset pops, then one per step
    exogenous_noise: bool = False


def config_for_sensor(sensor: str = "Dexcom", **overrides) -> RolloutConfig:
    """RolloutConfig with the named sensor's row of the sensor table."""
    from simglucose_tpu_torch.params import sensor_record

    rec = sensor_record(sensor)
    fields = dict(
        sample_time=int(rec["sample_time"]),
        pacf=float(rec["PACF"]),
        gamma=float(rec["gamma"]),
        lam=float(rec["lambda"]),
        delta=float(rec["delta"]),
        xi=float(rec["xi"]),
        cgm_min=float(rec["min"]),
        cgm_max=float(rec["max"]),
    )
    fields.update(overrides)
    return RolloutConfig(**fields)


def validate(cfg: RolloutConfig) -> None:
    """Reject configs the rollout cannot run (the JAX wrapper's checks,
    pallas_rollout.py:1298-1351, for the fields the port keeps)."""
    if cfg.controller not in CONTROLLERS:
        raise ValueError(f"controller must be one of {CONTROLLERS}; got {cfg.controller!r}")
    if cfg.exogenous_noise and cfg.autoreset:
        raise ValueError(
            "exogenous_noise requires autoreset=False (in-step resets would "
            "need reset-noise indexing the planes don't carry)"
        )
    if cfg.scenario_kind not in ("random", "static"):
        raise ValueError(
            f"scenario_kind must be 'random' or 'static'; got {cfg.scenario_kind!r}"
        )
    if len(cfg.det_meal_times) != len(cfg.det_meal_amounts):
        raise ValueError("det_meal_times and det_meal_amounts must have the same length")
    if cfg.reward_kind not in ("risk_diff", "neg_risk"):
        raise ValueError(
            f"reward_kind must be 'risk_diff' or 'neg_risk'; got {cfg.reward_kind!r}"
        )
    if cfg.sample_time < 1 or cfg.n_steps < 1:
        raise ValueError("sample_time and n_steps must be >= 1")
    if cfg.nn_emit_learner_rows and cfg.controller != "nn":
        raise ValueError("nn_emit_learner_rows requires controller='nn'")
    if cfg.controller == "nn":
        if cfg.nn_hidden < 8 or cfg.nn_hidden % 8:
            raise ValueError("nn_hidden must be a positive multiple of 8")
        if cfg.nn_decoder not in DECODERS:
            raise ValueError(
                f"nn_decoder must be 'sigmoid' or 'residual_bb'; got {cfg.nn_decoder!r}"
            )
        if cfg.exogenous_noise and not cfg.deterministic and cfg.nn_sample_actions:
            raise ValueError(
                "'nn' + exogenous_noise requires mean actions (deterministic=True "
                "or nn_sample_actions=False): sampled actions have no exogenous source"
            )


def pack_params(params: PatientParams, basal: torch.Tensor, quest=None) -> torch.Tensor:
    """PatientParams [B] -> packed float32 planes ``[NP_PLANES, rows, 128]``.

    Without ``quest`` the CR/CF planes hold a finite ``-1.0`` sentinel that
    the rollout reads as NaN, so a config that doses from them (``'bb'``)
    fails loudly instead of dosing with made-up ratios."""
    cols = [getattr(params, f) for f in _PARAM_FIELDS]
    cols += [params.x0[:, i] for i in range(13)]
    cols += [basal]
    if quest is not None:
        cols += [quest.CR, quest.CF]
    else:
        sentinel = torch.full_like(torch.as_tensor(basal, dtype=torch.float32), -1.0)
        cols += [sentinel, sentinel]
    flat = torch.stack([torch.as_tensor(c).to(torch.float32) for c in cols])  # [NP, B]
    B = flat.shape[1]
    if B % LANES:
        raise ValueError(f"batch {B} must be a multiple of {LANES}")
    return flat.reshape(NP_PLANES, B // LANES, LANES)


def packed_basal(packed: torch.Tensor) -> torch.Tensor:
    """The per-patient basal plane of :func:`pack_params`, as ``[B]``."""
    return packed[len(_PARAM_FIELDS) + 13].reshape(-1)


def pack_policy_weights(params) -> torch.Tensor:
    """PolicyParams (:mod:`simglucose_tpu_torch.rl.policy`) -> the ``'nn'``
    controller's ``[H, H+16]`` float32 buffer, the JAX package's layout:
    ``[0:7]`` w1^T | ``[7]`` b1 | ``[8]`` w_mu | ``[9]`` rows 0/1/2 =
    (b_mu, log_std, b_v) | ``[10]`` w_v | ``[12:12+H]`` w2^T | ``[12+H]``
    b2.  The kernel's trunk is relu: params of any other activation are
    rejected, so a network never runs as another one."""
    act = getattr(params, "act", "relu")
    if act != "relu":
        raise ValueError(
            f"the 'nn' controller implements a relu trunk; got params with "
            f"act={act!r} (train/init the policy with act='relu')"
        )
    H = params.b1.shape[0]
    if params.w1.shape[0] != 7:
        raise ValueError(
            f"the 'nn' controller implements the OBS_DIM=7 featurizer; got w1 "
            f"with obs dim {params.w1.shape[0]}"
        )
    f32 = torch.float32
    buf = torch.zeros(H, H + 16, dtype=f32, device=params.w1.device)
    buf[:, 0:7] = params.w1.T.to(f32)
    buf[:, 7] = params.b1.to(f32)
    buf[:, 8] = params.w_mu[:, 0].to(f32)
    buf[0:3, 9] = torch.cat([params.b_mu, params.log_std, params.b_v]).to(f32)
    buf[:, 10] = params.w_v[:, 0].to(f32)
    buf[:, 12:12 + H] = params.w2.T.to(f32)
    buf[:, 12 + H] = params.b2.to(f32)
    return buf


def _key(seed) -> tuple:
    """int seed -> (seed, 0); a pair -> itself; words taken mod 2**32."""
    if isinstance(seed, (tuple, list)):
        k0, k1 = seed
    else:
        k0, k1 = seed, 0
    return int(k0) & 0xFFFFFFFF, int(k1) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Plain version: per-patient math on [B] tensors
# ---------------------------------------------------------------------------


def _words(key, lane, step, site: int, n_quads: int) -> list:
    out = []
    for q in range(n_quads):
        out += philox4x32(lane, step, site + q, 0, *key)
    return out


def _box_muller(w1, w2):
    """Two N(0,1) from two words."""
    r = torch.sqrt(-2.0 * torch.log(uniform(w1)))
    th = (2.0 * math.pi) * uniform(w2)
    return r * torch.cos(th), r * torch.sin(th)


_NDTRI_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
            1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_NDTRI_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
            6.680131188771972e01, -1.328068155288572e01)
_NDTRI_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
            -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_NDTRI_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
            3.754408661907416e00)


def _ndtri_central(p):
    """Central branch of Acklam's inverse normal CDF (valid inside +/-2 sigma)."""
    a, b = _NDTRI_A, _NDTRI_B
    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r) + 1.0
    return num * q / den


def _ndtri_tail(q):
    c, d = _NDTRI_C, _NDTRI_D
    num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
    den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
    return num, den


def _ndtri(p):
    """Acklam's inverse normal CDF, all three branches."""
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    num_l, den_l = _ndtri_tail(torch.sqrt(-2.0 * torch.log(p)))
    num_u, den_u = _ndtri_tail(torch.sqrt(-2.0 * torch.log(1.0 - p)))
    return torch.where(
        p < 0.02425,
        num_l / den_l,
        torch.where(p > 1.0 - 0.02425, -num_u / den_u, _ndtri_central(p)),
    )


def _johnson(cfg, x):
    z = (x - cfg.gamma) / cfg.delta
    ez = torch.exp(z)
    return cfg.xi + cfg.lam * 0.5 * (ez - 1.0 / ez)


def _catmull(l0, l1, l2, l3, u):
    m1 = 0.5 * (l2 - l0)
    m2 = 0.5 * (l3 - l1)
    u2 = u * u
    u3 = u2 * u
    return (
        (2.0 * u3 - 3.0 * u2 + 1.0) * l1
        + (u3 - 2.0 * u2 + u) * m1
        + (-2.0 * u3 + 3.0 * u2) * l2
        + (u3 - u2) * m2
    )


def _quantize(amount, inc, lo, hi):
    """Pump quantization; torch.round is round-half-to-even like jnp.round."""
    return torch.clamp(torch.round(amount * 6000.0 / inc) * inc / 6000.0, lo, hi)


def _risk_of(bg):
    logbg = torch.log(torch.clamp(bg, min=1.0))
    f = 1.509 * (torch.pow(logbg, 1.084) - 5.381)
    return 10.0 * f * f


def _draw_meal_plan(w):
    """One day's plan from 18 words: (times[6], amounts[6]); a skipped slot
    has time -1 and amount 0."""
    amt_z = []
    for i in range(3):
        amt_z += _box_muller(w[2 * i], w[2 * i + 1])
    times, amounts = [], []
    for s in range(6):
        u_occ = uniform(w[6 + 2 * s])
        u_t = uniform(w[7 + 2 * s])
        inv = _ndtri if _MEAL_FULL_NDTRI[s] else _ndtri_central
        t = torch.round(_TIME_MU[s] + _TIME_SIGMA[s] * inv(_MEAL_CDF_LO[s] + u_t * _MEAL_CDF_SPAN[s]))
        amt = torch.clamp(torch.round(_AMOUNT_MU[s] + _AMOUNT_SIGMA[s] * amt_z[s]), min=0.0)
        occurs = u_occ < _MEAL_PROB[s]
        times.append(torch.where(occurs, t, torch.full_like(t, -1.0)))
        amounts.append(torch.where(occurs, amt, torch.zeros_like(amt)))
    return times, amounts


def _reset_draw(cfg, w, x0, Vg):
    """Fresh-episode patient/sensor values from 7 words: ODE state, AR(1)
    state, lattice, start minute, reset CGM and its risk (the JAX kernel's
    ``_reset_values`` without the plan)."""
    xs = list(x0)
    zero = torch.zeros_like(x0[0])
    lattice_needed = not (cfg.deterministic or cfg.exogenous_noise)
    bg_z = lat_z = None
    if not cfg.deterministic:
        z = [*_box_muller(w[0], w[1]), *_box_muller(w[2], w[3]), *_box_muller(w[4], w[5])]
        if cfg.random_init_bg:
            bg_z = z[0:3]
            lat_z = z[3:6] if lattice_needed else None
        elif lattice_needed:
            lat_z = z[0:3]
    if bg_z is not None:
        for idx, zz in zip((3, 4, 12), bg_z):
            mean = x0[idx]
            xs[idx] = mean + torch.sqrt(0.1 * mean) * zz
    if lat_z is None:
        e, lat = zero, (zero, zero, zero, zero)
    else:
        e0 = lat_z[0]
        e1 = cfg.pacf * (e0 + lat_z[1])
        e2 = cfg.pacf * (e1 + lat_z[2])
        j0 = _johnson(cfg, e0)
        e, lat = e2, (j0, j0, _johnson(cfg, e1), _johnson(cfg, e2))
    if cfg.deterministic:
        start = torch.zeros(zero.shape, dtype=torch.int32, device=zero.device)
    elif cfg.fixed_start_min >= 0:
        start = torch.full(zero.shape, cfg.fixed_start_min, dtype=torch.int32, device=zero.device)
    else:
        start = (torch.floor(uniform(w[6]) * 24.0).to(torch.int32)) * 60
    cgm0 = torch.clamp(xs[12] / Vg + lat[1], cfg.cgm_min, cfg.cgm_max)
    return dict(xs=tuple(xs), e=e, lat=lat, start=start, cgm0=cgm0)


def _rk4_minute(p, xs, d_mg, ins_rate, Dbar):
    f = lambda ys: model_rhs_parts(ys, p, d_mg, ins_rate, Dbar)
    k1 = f(xs)
    k2 = f(tuple(y + 0.5 * k for y, k in zip(xs, k1)))
    k3 = f(tuple(y + 0.5 * k for y, k in zip(xs, k2)))
    k4 = f(tuple(y + k for y, k in zip(xs, k3)))
    return tuple(
        x + (1.0 / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(xs, k1, k2, k3, k4)
    )


def _nn_lane(basal):
    """Per-patient feature constants, hoisted out of the step loop."""
    b = basal + 1e-8
    return 1.0 / (3.0 * b), 1.0 / (120.0 * b), torch.tanh(20.0 * basal)


def _nn_features(lane_c, ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob):
    """rl/policy.py featurize_parts in the JAX kernel's form (constant
    reciprocals multiplied, pallas_rollout.py:910-916)."""
    inv3b, inv120b, f7 = lane_c
    return [
        ctrl_prev * 0.0025,
        (ctrl_prev - 140.0) * 0.01,
        torch.tanh(ins_prev * inv3b),
        torch.tanh(prev_cho * 0.1),
        torch.tanh((ctrl_prev - ctrl_pprev) * 0.1),
        torch.tanh(iob * inv120b),
        f7,
    ]


def _nn_mlp(wb, H, feats):
    """The relu trunk and heads from the packed weights: (mu, value) [B]."""
    x = torch.stack(feats)  # [7, B]
    h = torch.relu(wb[:, 0:7] @ x + wb[:, 7:8])
    h = torch.relu(wb[:, 12:12 + H] @ h + wb[:, 12 + H:13 + H])
    return wb[:, 8] @ h + wb[0, 9], wb[:, 10] @ h + wb[2, 9]


def _unpack_params(flat):
    """[NP, B] planes -> (PatientParams with a dummy x0, x0 tuple, basal, CR, CF)."""
    n = len(_PARAM_FIELDS)
    vals = {f: flat[i] for i, f in enumerate(_PARAM_FIELDS)}
    x0 = tuple(flat[n + i] for i in range(13))
    nan = torch.full_like(flat[0], float("nan"))
    CR = torch.where(flat[n + 14] > 0, flat[n + 14], nan)
    CF = torch.where(flat[n + 15] > 0, flat[n + 15], nan)
    return PatientParams(x0=x0[0], **vals), x0, flat[n + 13], CR, CF


def rollout_reference(
    cfg: RolloutConfig,
    packed: torch.Tensor,
    seed=0,
    reset_noise=None,
    step_noise=None,
    state=None,
    init: int = 1,
    step_offset: int = 0,
    weights=None,
    lane_offset: int = 0,
) -> dict:
    """Plain PyTorch version of the whole K1a/K1b kernel, vectorised over
    the patients of ``packed`` (``[NP_PLANES, rows, 128]``) on its device.

    Arguments and result are those of :func:`rollout`.  Per-lane branches
    of the kernel become ``torch.where`` selects; the counter-based
    generator makes both draw the same numbers."""
    validate(cfg)
    nn = cfg.controller == "nn"
    if nn:
        wb = _check_weights(cfg, weights, packed.device)
    key = _key(seed)
    dev = packed.device
    flat = packed.reshape(NP_PLANES, -1)
    B = flat.shape[1]
    st = cfg.sample_time
    inv_st = 1.0 / st
    T = cfg.n_steps
    p, x0, basal_u, quest_CR, quest_CF = _unpack_params(flat)
    lane = torch.arange(lane_offset, lane_offset + B, dtype=torch.int64, device=dev)
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    izero = torch.zeros(B, dtype=torch.int32, device=dev)
    native_noise = not (cfg.deterministic or cfg.exogenous_noise)
    random_meals = not cfg.deterministic and cfg.scenario_kind == "random"
    static_meals = [
        (int(t), float(a)) for t, a in zip(cfg.det_meal_times, cfg.det_meal_amounts)
    ]
    if cfg.exogenous_noise:
        rnoise = torch.as_tensor(reset_noise, dtype=torch.float32, device=dev).reshape(2, B)
        snoise = torch.as_tensor(step_noise, dtype=torch.float32, device=dev).reshape(-1, B)
    clip_cgm = lambda v: torch.clamp(v, cfg.cgm_min, cfg.cgm_max)

    if init:
        w = [] if cfg.deterministic else _words(key, lane, step_offset, SITE_INIT_RESET, 2)
        rv = _reset_draw(cfg, w, x0, p.Vg)
        xs = rv["xs"]
        bg0 = xs[12] / p.Vg
        if cfg.exogenous_noise:
            cgm_hist0 = clip_cgm(bg0 + rnoise[0])
            cgm_obs0 = clip_cgm(bg0 + rnoise[1])
        else:
            cgm_hist0 = cgm_obs0 = rv["cgm0"]
        if random_meals:
            meal_t, meal_a = _draw_meal_plan(
                _words(key, lane, step_offset, SITE_INIT_MEAL, 5)
            )
        else:
            meal_t, meal_a = [torch.full_like(zero, -1.0)] * 6, [zero] * 6
        s = dict(
            planned=zero, last_CHO=zero, eating=zero, last_Qsto=xs[0] + xs[1],
            foodtaken=zero, last_CGM=cgm_obs0, e=rv["e"], lat=list(rv["lat"]),
            pid_integ=zero, pid_prev=zero, prev_risk=_risk_of(cgm_hist0),
            prev_cho=zero, ctrl_prev=cgm_obs0, ins_prev=zero, ctrl_pprev=cgm_obs0,
            iob=zero, t_min=izero, start_min=rv["start"], day=izero, seg=izero,
            lat_next=torch.full_like(izero, 3), n_samp=izero,
        )
        rst = torch.stack([bg0, cgm_hist0])
    else:
        if state is None:
            raise ValueError("init=0 continues a state: pass state=(state_f, state_i)")
        sf = torch.as_tensor(state[0], device=dev).reshape(NS_F, B)
        si = torch.as_tensor(state[1], device=dev).reshape(NS_I, B)
        xs = tuple(sf[i] for i in range(13))
        meal_t = [sf[24 + i] for i in range(6)]
        meal_a = [sf[30 + i] for i in range(6)]
        s = dict(
            planned=sf[13], last_CHO=sf[14], eating=sf[15], last_Qsto=sf[16],
            foodtaken=sf[17], last_CGM=sf[18], e=sf[19],
            lat=[sf[20 + i] for i in range(4)], pid_integ=sf[36], pid_prev=sf[37],
            prev_risk=sf[38], prev_cho=sf[39], ctrl_prev=sf[40], ins_prev=sf[61],
            ctrl_pprev=sf[62], iob=sf[63], t_min=si[0], start_min=si[1], day=si[2],
            seg=si[3], lat_next=si[4], n_samp=si[5],
        )
        rst = torch.zeros(2, B, dtype=torch.float32, device=dev)

    outs = {k: [] for k in ("CGM", "BG", "reward", "done", "CHO", "insulin")}
    if nn:
        H = cfg.nn_hidden
        lane_c = _nn_lane(basal_u)
        log_std = wb[1, 9]
        sigma, inv_sigma = torch.exp(log_std), torch.exp(-log_std)
        sample = not cfg.deterministic and cfg.nn_sample_actions
        emit = cfg.nn_emit_learner_rows
        nn_rows = []  # per step: 10 learner rows (emit) or 6 observation planes
    for t in range(T):
        gstep = step_offset + t
        # ---- controller acts on the previous step's CGM observation ----
        obs = s["ctrl_prev"]
        if nn:
            feats = _nn_features(lane_c, obs, s["ins_prev"], s["prev_cho"], s["ctrl_pprev"], s["iob"])
            mu, v = _nn_mlp(wb, H, feats)
            raw = mu
            if sample:
                wz = philox4x32(lane, gstep, SITE_ACTION, 0, *key)
                raw = mu + sigma * _box_muller(wz[0], wz[1])[0]
            if emit:
                z_lp = (raw - mu) * inv_sigma
                logp = -0.5 * z_lp * z_lp - log_std - 0.5 * LOG_2PI
                nn_rows.append(feats + [v, raw, logp])
            else:
                nn_rows.append([raw, obs, s["ins_prev"], s["prev_cho"], s["ctrl_pprev"], s["iob"]])
            if cfg.nn_decoder == "residual_bb":
                meal_ann = s["prev_cho"]
                bolus_u = (meal_ann * st) / quest_CR + (obs > 150.0).to(torch.float32) * (
                    obs - cfg.bb_target
                ) / quest_CF
                bolus_cmd = torch.where(meal_ann > 0, bolus_u / st, zero)
                mod = torch.exp(cfg.nn_action_scale * torch.tanh(raw))
                insulin = _quantize((basal_u + bolus_cmd) * mod, cfg.inc_basal, cfg.min_basal,
                                    cfg.max_basal)
            else:
                cmd = cfg.nn_action_scale / (1.0 + torch.exp(-raw))
                if cfg.nn_scale_by_basal:
                    cmd = cmd * basal_u
                insulin = _quantize(cmd, cfg.inc_basal, cfg.min_basal, cfg.max_basal)
            s["iob"] = iob_step(s["iob"], insulin, st)
        elif cfg.controller == "pid":
            control = (
                cfg.pid_p * (obs - cfg.pid_target)
                + cfg.pid_i * s["pid_integ"]
                + cfg.pid_d * (obs - s["pid_prev"]) / st
            )
            s["pid_integ"] = s["pid_integ"] + (obs - cfg.pid_target) * st
            s["pid_prev"] = obs
            insulin = _quantize(control, cfg.inc_basal, cfg.min_basal, cfg.max_basal)
        elif cfg.controller == "bb":
            meal_ann = s["prev_cho"]
            bolus_u = (meal_ann * st) / quest_CR + (obs > 150.0).to(torch.float32) * (
                obs - cfg.bb_target
            ) / quest_CF
            bolus_cmd = torch.where(meal_ann > 0, bolus_u / st, zero)
            insulin = _quantize(
                basal_u, cfg.inc_basal, cfg.min_basal, cfg.max_basal
            ) + _quantize(bolus_cmd, cfg.inc_bolus, cfg.min_bolus, cfg.max_bolus)
        else:
            insulin = _quantize(
                torch.full_like(zero, cfg.const_basal), cfg.inc_basal, cfg.min_basal, cfg.max_basal
            )

        # ---- a new day's meal plan, drawn when this step reaches midnight ----
        if random_meals:
            day_end = (s["start_min"] + s["t_min"] + (st - 1)) // MINUTES_PER_DAY
            regen = day_end > s["day"]
            if bool(regen.any()):
                new_t, new_a = _draw_meal_plan(_words(key, lane, gstep, SITE_MEAL, 5))
                meal_t = [torch.where(regen, n, o) for n, o in zip(new_t, meal_t)]
                meal_a = [torch.where(regen, n, o) for n, o in zip(new_a, meal_a)]
            s["day"] = torch.maximum(s["day"], day_end)

        CHO_acc = BG_acc = CGM_acc = zero
        for m in range(st):
            if random_meals:
                modf = ((s["start_min"] + s["t_min"]) % MINUTES_PER_DAY).to(torch.float32)
                meal = zero
                taken = torch.zeros(B, dtype=torch.bool, device=dev)
                for k in range(6):
                    hit = (meal_t[k] == modf) & ~taken
                    meal = meal + hit.to(torch.float32) * meal_a[k]
                    taken = taken | hit
            else:
                meal = zero
                for tt, aa in static_meals:
                    meal = meal + (s["t_min"] == tt).to(torch.float32) * aa

            # meal announcement / eating state machine
            planned = s["planned"] + meal
            to_eat = torch.where(planned > 0, torch.clamp(planned, max=EAT_RATE), zero)
            s["planned"] = torch.clamp(planned - to_eat, min=0.0)
            starts = (to_eat > 0) & (s["last_CHO"] <= 0)
            s["last_Qsto"] = torch.where(starts, xs[0] + xs[1], s["last_Qsto"])
            foodtaken = torch.where(starts, zero, s["foodtaken"])
            eating_b = starts | (s["eating"] > 0)
            s["foodtaken"] = torch.where(eating_b, foodtaken + to_eat, foodtaken)
            ends = (to_eat <= 0) & (s["last_CHO"] > 0)
            s["eating"] = (eating_b & ~ends).to(torch.float32)
            s["last_CHO"] = to_eat

            d_mg = to_eat * 1000.0
            ins_rate = insulin * 6000.0 / p.BW
            Dbar = s["last_Qsto"] + s["foodtaken"] * 1000.0
            xs = _rk4_minute(p, xs, d_mg, ins_rate, Dbar)
            s["t_min"] = s["t_min"] + 1

            bg_m = xs[12] / p.Vg
            if m == st - 1:
                if cfg.exogenous_noise:
                    cgm_m = clip_cgm(bg_m + snoise[t])
                elif cfg.deterministic:
                    cgm_m = clip_cgm(bg_m)
                else:
                    tau = (s["n_samp"] + 1) * st
                    k = tau // MDL_SAMPLE_TIME
                    u = (tau - k * MDL_SAMPLE_TIME).to(torch.float32) / MDL_SAMPLE_TIME
                    need = (k + 2) >= s["lat_next"]
                    wz = philox4x32(lane, gstep, SITE_CGM, 0, *key)
                    z, _ = _box_muller(wz[0], wz[1])
                    e_new = cfg.pacf * (s["e"] + z)
                    eps_new = _johnson(cfg, e_new)
                    s["e"] = torch.where(need, e_new, s["e"])
                    lat = s["lat"]
                    s["lat"] = [
                        torch.where(need, nxt, cur)
                        for cur, nxt in zip(lat, [lat[1], lat[2], lat[3], eps_new])
                    ]
                    s["lat_next"] = s["lat_next"] + need.to(torch.int32)
                    s["seg"] = k
                    noise = _catmull(*s["lat"], u)
                    cgm_m = clip_cgm(bg_m + noise)
                    s["n_samp"] = s["n_samp"] + 1
                s["last_CGM"] = cgm_m
            else:
                cgm_m = s["last_CGM"]

            # the CHO history records the ANNOUNCED meal (reference
            # env.py:54,60), which is also the BB controller's input.  The
            # averages multiply by float32(1/st), as XLA compiles the JAX
            # package's division by the constant st: CHO stays bit-equal.
            CHO_acc = CHO_acc + meal * inv_st
            BG_acc = BG_acc + bg_m * inv_st
            CGM_acc = CGM_acc + cgm_m * inv_st

        # ---- reward / done ----
        risk_now = _risk_of(CGM_acc)
        if cfg.reward_kind == "neg_risk":
            reward = -0.1 * risk_now
        else:
            reward = s["prev_risk"] - risk_now
        done = (BG_acc < cfg.bg_done_low) | (BG_acc > cfg.bg_done_high)
        for k_, v in zip(outs, (CGM_acc, BG_acc, reward, done, CHO_acc, insulin)):
            outs[k_].append(v)

        s["prev_risk"] = risk_now
        s["prev_cho"] = CHO_acc
        s["ctrl_pprev"] = s["ctrl_prev"]
        s["ctrl_prev"] = CGM_acc
        s["ins_prev"] = insulin

        # ---- auto-reset with fresh draws; the meal plan is kept ----
        if cfg.autoreset and not cfg.deterministic and bool(done.any()):
            rv = _reset_draw(cfg, _words(key, lane, gstep, SITE_RESET, 2), x0, p.Vg)
            sel = lambda new, old: torch.where(done, new, old)
            xs = tuple(sel(n, o) for n, o in zip(rv["xs"], xs))
            cgm0 = rv["cgm0"]
            for name in ("planned", "last_CHO", "eating", "foodtaken", "pid_integ",
                         "pid_prev", "prev_cho", "ins_prev", "iob"):
                s[name] = sel(zero, s[name])
            s["last_Qsto"] = sel(rv["xs"][0] + rv["xs"][1], s["last_Qsto"])
            s["last_CGM"] = sel(cgm0, s["last_CGM"])
            s["e"] = sel(rv["e"], s["e"])
            s["lat"] = [sel(n, o) for n, o in zip(rv["lat"], s["lat"])]
            s["prev_risk"] = sel(_risk_of(cgm0), s["prev_risk"])
            s["ctrl_prev"] = sel(cgm0, s["ctrl_prev"])
            s["ctrl_pprev"] = sel(cgm0, s["ctrl_pprev"])
            for name in ("t_min", "day", "seg", "n_samp"):
                s[name] = sel(izero, s[name])
            s["start_min"] = sel(rv["start"], s["start_min"])
            s["lat_next"] = sel(torch.full_like(izero, 3), s["lat_next"])

    sf = torch.zeros(NS_F, B, dtype=torch.float32, device=dev)
    for i in range(13):
        sf[i] = xs[i]
    for i, name in enumerate(("planned", "last_CHO", "eating", "last_Qsto", "foodtaken",
                              "last_CGM", "e")):
        sf[13 + i] = s[name]
    for i in range(4):
        sf[20 + i] = s["lat"][i]
    for i in range(6):
        sf[24 + i] = meal_t[i]
        sf[30 + i] = meal_a[i]
    for i, name in enumerate(("pid_integ", "pid_prev", "prev_risk", "prev_cho", "ctrl_prev")):
        sf[36 + i] = s[name]
    for i, name in enumerate(("ins_prev", "ctrl_pprev", "iob")):
        sf[61 + i] = s[name]
    si = torch.zeros(NS_I, B, dtype=torch.int32, device=dev)
    for i, name in enumerate(("t_min", "start_min", "day", "seg", "lat_next", "n_samp")):
        si[i] = s[name]
    res = {k: torch.stack(v) for k, v in outs.items()}
    if not nn:
        return _result(res, rst, sf, si)
    # the observation the next step would act on: its value or its inputs
    tail_in = (s["ctrl_prev"], s["ins_prev"], s["prev_cho"], s["ctrl_pprev"], s["iob"])
    if cfg.nn_emit_learner_rows:
        tail = [_nn_mlp(wb, H, _nn_features(lane_c, *tail_in))[1]]
    else:
        tail = list(tail_in)
    rst = torch.cat([rst, torch.stack(tail)])
    planes = torch.stack([torch.stack(r) for r in nn_rows], dim=1)  # [10 | 6, T, B]
    return _result(res, rst, sf, si, planes, cfg)


_OBS_PLANES = ("raw", "octrl", "oins", "ocho", "oprev", "oiob")


def _result(traj: dict, rst, sf, si, nn_planes=None, cfg=None) -> dict:
    """The result dict of :func:`rollout` from the kernel's outputs; for
    the 'nn' controller ``nn_planes`` is the [10, T, B] learner buffer or
    the [6, T, B] observation planes and ``rst`` carries the tail rows."""
    out = dict(traj)
    out["done"] = out["done"] > 0.5
    out["BG0"], out["CGM0"] = rst[0], rst[1]
    if nn_planes is not None:
        T, B = nn_planes.shape[1:]
        if cfg.nn_emit_learner_rows:
            # column t*B + b, the layout gae_pack and the grad step read
            out["learner"] = nn_planes.reshape(10, T * B)
            out["value"] = nn_planes[7]
            out["tail_value"] = rst[2]
        else:
            for i, k in enumerate(_OBS_PLANES):
                out[k] = nn_planes[i]
            for i, k in enumerate(_OBS_PLANES[1:]):
                out["tail_" + k] = rst[2 + i]
    out["state_f"] = sf.reshape(NS_F, -1, LANES)
    out["state_i"] = si.reshape(NS_I, -1, LANES)
    return out


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


# Launch shapes of the kernels, mirrored from csrc/rollout_math.cuh:
# threads per block and the lanes that run one patient (K1b's split its MLP).
K1A_THREADS, K1A_GROUP = 32, 1
K1B_THREADS, K1B_GROUP = 128, 4


class _CConfig(ctypes.Structure):
    """Mirror of ``RolloutCfg`` in csrc/rollout_math.cuh (all 4-byte fields,
    same order)."""

    _fields_ = (
        [(n, ctypes.c_int32) for n in ("B", "T", "step_offset", "init")]
        + [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
        + [(n, ctypes.c_int32) for n in (
            "sample_time", "controller", "deterministic", "exogenous_noise",
            "scenario_static", "autoreset", "random_init_bg", "reward_neg_risk",
            "fixed_start_min", "n_meals")]
        + [(n, ctypes.c_float) for n in (
            "pacf", "gamma", "lam", "delta", "xi", "cgm_min", "cgm_max",
            "inc_basal", "min_basal", "max_basal", "inc_bolus", "min_bolus",
            "max_bolus", "pid_p", "pid_i", "pid_d", "pid_target", "bb_target",
            "const_basal", "bg_done_low", "bg_done_high")]
        + [("meal_cdf_lo", ctypes.c_float * 6), ("meal_cdf_span", ctypes.c_float * 6),
           ("meal_full_ndtri", ctypes.c_int32 * 6)]
        + [(n, ctypes.c_int32) for n in (
            "nn_hidden", "nn_scale_by_basal", "nn_sample_actions", "nn_residual_bb", "nn_emit")]
        + [("nn_action_scale", ctypes.c_float), ("iob_decay", ctypes.c_float)]
        + [("lane0", ctypes.c_int32)]
    )


def _c_config(cfg: RolloutConfig, B: int, key, init: int, step_offset: int,
              lane_offset: int = 0) -> _CConfig:
    c = _CConfig()
    c.B, c.T, c.step_offset, c.init = B, cfg.n_steps, step_offset, int(bool(init))
    c.key0, c.key1 = key
    c.sample_time = cfg.sample_time
    c.controller = CONTROLLERS.index(cfg.controller)
    c.deterministic = int(cfg.deterministic)
    c.exogenous_noise = int(cfg.exogenous_noise)
    c.scenario_static = int(cfg.scenario_kind == "static")
    c.autoreset = int(cfg.autoreset)
    c.random_init_bg = int(cfg.random_init_bg)
    c.reward_neg_risk = int(cfg.reward_kind == "neg_risk")
    c.fixed_start_min = cfg.fixed_start_min
    c.n_meals = len(cfg.det_meal_times)
    for n in ("pacf", "gamma", "lam", "delta", "xi", "cgm_min", "cgm_max",
              "inc_basal", "min_basal", "max_basal", "inc_bolus", "min_bolus",
              "max_bolus", "pid_p", "pid_i", "pid_d", "pid_target", "bb_target",
              "const_basal", "bg_done_low", "bg_done_high"):
        setattr(c, n, getattr(cfg, n))
    c.meal_cdf_lo[:] = _MEAL_CDF_LO
    c.meal_cdf_span[:] = _MEAL_CDF_SPAN
    c.meal_full_ndtri[:] = [int(v) for v in _MEAL_FULL_NDTRI]
    c.nn_hidden = cfg.nn_hidden
    c.nn_scale_by_basal = int(cfg.nn_scale_by_basal)
    c.nn_sample_actions = int(cfg.nn_sample_actions)
    c.nn_residual_bb = int(cfg.nn_decoder == "residual_bb")
    c.nn_emit = int(cfg.nn_emit_learner_rows)
    c.nn_action_scale = cfg.nn_action_scale
    c.iob_decay = iob_decay(cfg.sample_time)
    c.lane0 = lane_offset
    return c


def _check_plane(name, t, n_planes, B, dtype, dev):
    if t.device != dev or t.dtype != dtype or t.numel() != n_planes * B or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of {n_planes}x{B} "
            f"elements on {dev}; got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _check_weights(cfg, weights, dev) -> torch.Tensor:
    """The 'nn' controller's packed weights, checked against the config."""
    if weights is None:
        raise ValueError("the 'nn' controller needs weights= (pack_policy_weights)")
    H = cfg.nn_hidden
    w = torch.as_tensor(weights)
    if w.shape != (H, H + 16) or w.dtype != torch.float32 or w.device != dev:
        raise ValueError(
            f"weights must be a float32 [{H}, {H + 16}] tensor on {dev} "
            f"(pack_policy_weights, nn_hidden={H}); got {tuple(w.shape)} {w.dtype} on {w.device}"
        )
    return w.contiguous()


def _rollout_cuda(cfg, packed, key, reset_noise, step_noise, state, init, step_offset, weights,
                  lane_offset):
    from simglucose_tpu_torch.ops.build import load_library

    lib = load_library()
    dev = packed.device
    B = packed.numel() // NP_PLANES
    T = cfg.n_steps
    _check_plane("packed", packed, NP_PLANES, B, torch.float32, dev)
    keep = []  # tensors whose memory the launch reads

    def ptr(t):
        if t is None:
            return None
        keep.append(t)
        return t.data_ptr()

    meal_times = meal_amounts = None
    if cfg.det_meal_times:
        meal_times = torch.tensor(cfg.det_meal_times, dtype=torch.int32, device=dev)
        meal_amounts = torch.tensor(cfg.det_meal_amounts, dtype=torch.float32, device=dev)
    rn = sn = None
    if cfg.exogenous_noise:
        rn = torch.as_tensor(reset_noise, dtype=torch.float32, device=dev).contiguous()
        sn = torch.as_tensor(step_noise, dtype=torch.float32, device=dev).contiguous()
        _check_plane("reset_noise", rn, 2, B, torch.float32, dev)
        _check_plane("step_noise", sn, T, B, torch.float32, dev)
    sf_in = si_in = None
    if not init:
        if state is None:
            raise ValueError("init=0 continues a state: pass state=(state_f, state_i)")
        sf_in, si_in = state
        _check_plane("state_f", sf_in, NS_F, B, torch.float32, dev)
        _check_plane("state_i", si_in, NS_I, B, torch.int32, dev)
    nn = cfg.controller == "nn"
    out = torch.empty(6, T, B, dtype=torch.float32, device=dev)
    n_rst = (3 if cfg.nn_emit_learner_rows else 7) if nn else 2
    rst = torch.zeros(n_rst, B, dtype=torch.float32, device=dev)
    sf = torch.empty(NS_F, B, dtype=torch.float32, device=dev)
    si = torch.empty(NS_I, B, dtype=torch.int32, device=dev)
    c = _c_config(cfg, B, key, init, step_offset, lane_offset)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (ptr(packed), ptr(meal_times), ptr(meal_amounts), ptr(rn), ptr(sn), ptr(sf_in),
              ptr(si_in))
    if nn:
        planes = torch.empty(10 if cfg.nn_emit_learner_rows else 6, T, B, dtype=torch.float32,
                             device=dev)
        lrn, obs = (planes, None) if cfg.nn_emit_learner_rows else (None, planes)
        with span("rollout.launch"):
            err = lib.sgt_rollout_nn_launch(
                ctypes.addressof(c), *common, ptr(_check_weights(cfg, weights, dev)), ptr(out),
                ptr(lrn), ptr(obs), ptr(rst), ptr(sf), ptr(si), stream,
            )
        if err != 0:
            raise RuntimeError(f"rollout 'nn' kernel launch failed: CUDA error {err}")
        LAUNCHES["rollout_nn"] += 1
    else:
        planes = None
        with span("rollout.launch"):
            err = lib.sgt_rollout_launch(
                ctypes.addressof(c), *common, ptr(out), ptr(rst), ptr(sf), ptr(si), stream,
            )
        if err != 0:
            raise RuntimeError(f"rollout kernel launch failed: CUDA error {err}")
        LAUNCHES["rollout"] += 1
    traj = dict(zip(("CGM", "BG", "reward", "done", "CHO", "insulin"), out.unbind(0)))
    return _result(traj, rst, sf, si, planes, cfg)


@span("rollout")
def rollout(
    cfg: RolloutConfig,
    packed: torch.Tensor,
    seed=0,
    reset_noise=None,
    step_noise=None,
    state=None,
    init: int = 1,
    step_offset: int = 0,
    weights=None,
    lane_offset: int = 0,
) -> dict:
    """Run ``cfg.n_steps`` closed-loop steps for every patient of ``packed``.

    ``seed`` is an int (key (seed, 0)) or a (scenario seed, cgm seed) pair.
    ``init=1`` draws fresh episodes; ``init=0`` continues
    ``state=(state_f, state_i)`` from an earlier call, and ``step_offset``
    is then the global index of this call's first step, so a horizon cut
    into calls draws exactly what one call would.  ``lane_offset`` is the
    global lane of ``packed``'s first patient: the streams are keyed by
    global lane, so a shard of a batch (:func:`make_sharded_rollout`)
    draws exactly what its lanes draw in the whole batch.  Exogenous-noise
    configs take ``reset_noise`` ``[2, rows, 128]`` and ``step_noise``
    ``[n_steps, rows, 128]``.

    Returns ``[T, B]`` planes ``CGM BG reward done CHO insulin``, the reset
    row ``BG0``/``CGM0`` ``[B]`` (meaningful on ``init=1``) and the final
    ``state_f``/``state_i``.

    The ``'nn'`` controller takes ``weights`` (:func:`pack_policy_weights`)
    and adds, with ``nn_emit_learner_rows``, ``learner`` ``[10, T*B]``
    (column ``t*B + b``: rows 0-6 the features, 7 the value, 8 the raw
    action, 9 its log-prob), ``value`` (a ``[T, B]`` view of row 7) and
    ``tail_value`` ``[B]``; otherwise the ``[T, B]`` planes ``raw octrl oins
    ocho oprev oiob`` and the tail observation ``tail_octrl`` ...
    ``tail_oiob`` ``[B]``.  The action noise is one Philox normal per
    patient-step (draw site ``SITE_ACTION``).

    On a CPU tensor this runs :func:`rollout_reference`; on a CUDA tensor
    it launches the CUDA kernel or raises."""
    validate(cfg)
    if cfg.exogenous_noise and (reset_noise is None or step_noise is None):
        raise ValueError(
            "exogenous_noise config needs reset_noise [2, rows, 128] and "
            "step_noise [n_steps, rows, 128]"
        )
    packed = torch.as_tensor(packed)
    if packed.ndim != 3 or packed.shape[0] != NP_PLANES or packed.shape[2] != LANES:
        raise ValueError(
            f"packed must be [{NP_PLANES}, rows, {LANES}] (pack_params); got {tuple(packed.shape)}"
        )
    key = _key(seed)
    if not 0 <= lane_offset < 2**31 - packed.numel() // NP_PLANES:
        raise ValueError(f"lane_offset {lane_offset} out of range")
    args = (cfg, packed, key, reset_noise, step_noise, state, init, step_offset, weights,
            lane_offset)
    if packed.device.type == "cpu":
        return rollout_reference(*args)
    if packed.device.type == "cuda":
        return _rollout_cuda(*args)
    raise ValueError(f"rollout runs on 'cpu' or 'cuda' tensors; got {packed.device}")


def make_sharded_rollout(cfg: RolloutConfig, batch: int, mesh):
    """The rollout over a global ``batch`` split by 128-lane rows over the
    ranks of ``mesh`` (:mod:`simglucose_tpu_torch.parallel.sharding`): the
    counterpart of the JAX ``make_sharded_pallas_rollout``, with no
    communication during the rollout.

    Returns ``run(packed, seed, reset_noise=None, step_noise=None,
    weights=None, state=None, init=1, step_offset=0)``: ``packed`` and the
    noise planes are the global ``[planes, rows, 128]`` tensors, of which
    each rank runs its contiguous rows; ``state`` is the rank's own (what
    the previous call returned); ``weights`` are replicated.  Each rank
    calls :func:`rollout` with ``lane_offset`` its first global lane, so it
    draws exactly what its lanes draw in the whole batch (the JAX package
    offsets each device's seed instead, which aliases streams).  The result
    is :func:`rollout`'s for the rank's lanes; callers gather it.  The rows
    go by ``dp_rank``: the ``tp`` ranks of one ``dp`` coordinate run the
    same lanes (JAX's ``shard_map`` over ``'dp'``), each with the whole
    policy."""
    from simglucose_tpu_torch.parallel.sharding import check_mesh

    n = check_mesh(mesh).dp
    if batch % (n * LANES):
        raise ValueError(f"global batch {batch} must divide into {n} ranks x {LANES} lanes")
    if cfg.nn_emit_learner_rows:
        raise ValueError(
            "nn_emit_learner_rows is the single-device fused-learner fast path (the [10, T*B] "
            "buffer's flat column index interleaves the batch axis); the mesh trainer uses the "
            "observation-plane outputs (rl/fused.py kernel_prep=False)")
    validate(cfg)
    rows = batch // LANES // n
    r0 = mesh.dp_rank * rows

    def local(planes):
        if planes is None:
            return None
        planes = torch.as_tensor(planes)
        if planes.shape[1:] != (batch // LANES, LANES):
            raise ValueError(f"expected global [planes, {batch // LANES}, {LANES}] planes; "
                             f"got {tuple(planes.shape)}")
        return planes[:, r0:r0 + rows].contiguous()

    def run(packed, seed, reset_noise=None, step_noise=None, weights=None, state=None,
            init: int = 1, step_offset: int = 0):
        return rollout(cfg, local(packed), seed, reset_noise=local(reset_noise),
                       step_noise=local(step_noise), state=state, init=init,
                       step_offset=step_offset, weights=weights, lane_offset=r0 * LANES)

    return run
