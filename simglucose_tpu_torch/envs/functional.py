"""The closed-loop T1D environment in PyTorch, and its reward windows.

Counterpart of ``simglucose_tpu/envs/functional.py``: one env step is
``sample_time`` one-minute patient updates (the reference's ``mini_step``),
a CGM sample at the step's last minute (zero-order hold before it), the
step's averages accumulated in the reference's ``acc += v / sample_time``
order, the risk indices, the reward over the last hour of CGM (a ring
buffer carried in the state) and termination.  A reset draws two sensor
samples, as the reference does: the history's first entry and the reset
observation.

Batch-native: :func:`env_reset` and :func:`env_step` take the envs' leading
batch axes (the JAX functions are single-env and vmapped), with branchless
``torch.where`` selects and no host synchronization, so a time loop of them
runs on the card without stalls.  Every constant is made in the state's
dtype on its device: float32 and float64 each run end to end.

Modes (``EnvConfig``): ``noise_mode`` 'native' (the port's Philox noise
chain) or 'exogenous' (``EnvParams.noise_seq``); ``scenario_mode`` 'random'
(daily plans from the port's Philox streams), 'exogenous'
(``EnvParams.meal_seq``, grams per episode minute), 'custom'
(``custom_times`` / ``custom_amounts``) or 'none'.  The JAX package's 'xs'
modes feed pregenerated streams through its scan and are not ported.

Also here: the one-hour reward window law and the replay of the per-step
reward plane from a CGM trajectory, which is how the simulation engine
serves any window-based ``reward_fun`` after the rollout kernel has run.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import torch

from simglucose_tpu_torch.analysis.risk import risk_diff_reward, risk_scalar
from simglucose_tpu_torch.core.types import (
    CtrlAction,
    EnvState,
    Observation,
    PatientAction,
    PatientParams,
    PumpParams,
    SensorParams,
    StepResult,
)
from simglucose_tpu_torch.devices.cgm import sensor_init, sensor_sample, take
from simglucose_tpu_torch.devices.pump import pump_basal, pump_bolus
from simglucose_tpu_torch.models.patient import patient_init, patient_step
from simglucose_tpu_torch.models.uva_padova import observe_gsub
from simglucose_tpu_torch.scenario.meal import (
    custom_meals_for_step,
    scenario_init,
    scenario_lookup_for_step,
    scenario_meals_for_step,
)


def reward_window_size(sample_time: int) -> int:
    """One hour of CGM samples (reference env.py:100), at least 2."""
    return max(60 // int(sample_time), 2)


def wrap_reward_fn(reward_fun: Callable, window_size: int) -> Callable:
    """Adapt a reference-style 1-argument reward over the BG-last-hour
    history to the native ``(window, window_len)`` signature.

    The reference passes ``CGM_hist[-window_size:]``, which is shorter than
    an hour at episode start; the wrapper hands each lane exactly its
    ``window_len`` most recent samples, as a 1-D tensor.  Native 2-argument
    functions (over a ``[..., W]`` window, time last) pass through.

    ``window_len`` is an int (every lane alike) or, in the env step, a
    per-lane tensor: then the function runs on every lane at every length
    1..W and each lane keeps its own length's value, so the step stays free
    of host synchronization at W times the calls."""
    try:
        n_params = len(inspect.signature(reward_fun).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 2:
        return reward_fun
    W = int(window_size)

    def at_length(window: torch.Tensor, L: int) -> torch.Tensor:
        return torch.stack(
            [
                torch.as_tensor(reward_fun(lane[W - L:]), dtype=window.dtype, device=window.device)
                for lane in window.reshape(-1, W)
            ]
        ).reshape(window.shape[:-1])

    def wrapped(window: torch.Tensor, window_len) -> torch.Tensor:
        if not isinstance(window_len, torch.Tensor):
            return at_length(window, min(max(int(window_len), 1), W))
        every = torch.stack([at_length(window, L) for L in range(1, W + 1)], dim=-1)
        idx = torch.clamp(window_len, 1, W) - 1
        return take(every, idx)

    return wrapped


def reward_history(window_size: int, cgm0: torch.Tensor):
    """The ring buffer at reset: ``([W-1, B] samples, 1 real)``, all zero
    but the reset history sample ``cgm0`` at the end."""
    W = int(window_size)
    pad = torch.zeros(W - 2, *cgm0.shape, dtype=cgm0.dtype, device=cgm0.device)
    return torch.cat([pad, cgm0[None]]), 1


def replay_rewards(reward_fun: Callable, window_size: int, history, cgm: torch.Tensor):
    """Rewards of the ``[T, B]`` CGM steps that follow ``history``.

    ``history`` is ``(samples [W-1, B], n_real)``: the ``W-1`` most recent
    samples before the first step, oldest first, of which the last
    ``n_real`` are real.  Step ``t``'s window is the last ``W`` samples
    once its CGM is appended, with ``min(n_real + t + 1, W)`` of them real.
    The reward function sees every full window in one call over a
    ``[T', B, W]`` stack (``unfold``); only the first steps, whose window
    is still filling, are called one by one.  Returns the ``[T, B]``
    rewards and the history that follows the last step, so a trajectory
    replayed in pieces gives the same rewards as in one piece."""
    rf = wrap_reward_fn(reward_fun, window_size)
    W = int(window_size)
    past, n_real = history
    seq = torch.cat([past, cgm])
    windows = seq.unfold(0, W, 1)  # [T, B, W], time last
    T = cgm.shape[0]
    out = torch.empty(cgm.shape, dtype=cgm.dtype, device=cgm.device)
    filling = min(max(W - 1 - n_real, 0), T)
    for t in range(filling):
        out[t] = torch.as_tensor(rf(windows[t], n_real + t + 1), dtype=cgm.dtype, device=cgm.device)
    if filling < T:
        out[filling:] = torch.as_tensor(rf(windows[filling:], W), dtype=cgm.dtype, device=cgm.device)
    return out, (seq[seq.shape[0] - (W - 1):], min(n_real + T, W - 1))


def rewards_from_cgm(
    reward_fun: Callable, window_size: int, cgm0: torch.Tensor, cgm: torch.Tensor
) -> torch.Tensor:
    """The ``[T, B]`` reward plane of a CGM trajectory, replaying the
    environment's ring-buffer window: the window starts as ``[cgm0]`` (the
    reset history sample, length 1) and each step appends that step's CGM,
    keeping the last ``window_size`` samples."""
    rewards, _ = replay_rewards(reward_fun, window_size, reward_history(window_size, cgm0), cgm)
    return rewards


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration."""

    sample_time: int = 3  # CGM sampling period, min (Dexcom)
    substeps: int = 1  # ODE substeps per minute
    method: str = "rk45"  # 'rk45' | 'rk4'
    noise_mode: str = "native"  # 'native' | 'exogenous'
    scenario_mode: str = "random"  # 'random' | 'exogenous' | 'custom' | 'none'
    random_init_bg: bool = False
    bg_done_low: float = 70.0  # episode termination
    bg_done_high: float = 350.0

    @property
    def window_size(self) -> int:
        """Reward window: one hour of CGM samples."""
        return reward_window_size(self.sample_time)


class EnvParams(NamedTuple):
    """Per-run parameters and the optional exogenous sequences, each with
    the envs' leading batch axes (or shared and broadcast): ``noise_seq``
    ``[..., N]`` noise values, ``meal_seq`` ``[..., M]`` grams per minute of
    the episode, ``custom_times`` / ``custom_amounts`` ``[..., K]`` a custom
    scenario in minutes since the start (int) and grams."""

    patient: PatientParams
    sensor: SensorParams
    pump: PumpParams
    noise_seq: Optional[torch.Tensor] = None
    meal_seq: Optional[torch.Tensor] = None
    custom_times: Optional[torch.Tensor] = None
    custom_amounts: Optional[torch.Tensor] = None


def _noise_seq(cfg: EnvConfig, params: EnvParams) -> Optional[torch.Tensor]:
    """``cfg.noise_mode`` decides; a disagreement with the params is an
    error, never a silent fall back to the other noise source."""
    if cfg.noise_mode == "exogenous":
        if params.noise_seq is None:
            raise ValueError(
                "noise_mode='exogenous' requires EnvParams.noise_seq "
                "(host-pregenerated noise values, e.g. compat.reference_cgm_noise)"
            )
        return params.noise_seq
    if cfg.noise_mode != "native":
        raise ValueError(f"unknown noise_mode {cfg.noise_mode!r} (the 'xs' modes are not ported)")
    if params.noise_seq is not None:
        raise ValueError(
            "noise_mode='native' but EnvParams.noise_seq is set — build the "
            "config with noise_mode='exogenous' (make_env does this when "
            "noise_seq is passed)"
        )
    return None


def env_reset(
    cfg: EnvConfig,
    params: EnvParams,
    key: torch.Tensor,
    start_min=0,
    init_state: Optional[torch.Tensor] = None,
):
    """Fresh episodes for every env: ``(state, reset StepResult)``.

    ``key`` is the envs' int64 ``[..., 4]`` Philox key
    (:func:`~simglucose_tpu_torch.ops.streams.env_keys`); the patient, the
    sensor and the scenario draw from it at their own sites.
    ``start_min`` (an int or an int tensor) is the start's minute of day,
    which sets the scenario's midnights."""
    dtype = params.patient.x0.dtype
    patient = patient_init(params.patient, key=key, random_init_bg=cfg.random_init_bg,
                           init_state=init_state, dtype=dtype)
    sensor = sensor_init(params.sensor, key, dtype=dtype)
    scenario = scenario_init(key, start_min, dtype=dtype)

    BG0 = observe_gsub(patient.x, params.patient)
    LBGI, HBGI, risk = risk_scalar(BG0)

    # two reset-time sensor samples, like the reference
    noise_seq = _noise_seq(cfg, params)
    sensor, CGM_hist0 = sensor_sample(params.sensor, cfg.sample_time, sensor, BG0, noise_seq)
    sensor, CGM_obs = sensor_sample(params.sensor, cfg.sample_time, sensor, BG0, noise_seq)

    batch = BG0.shape
    W = cfg.window_size
    window = torch.cat([torch.zeros(batch + (W - 1,), dtype=dtype, device=BG0.device),
                        CGM_hist0[..., None]], dim=-1)
    ints = torch.zeros(batch, dtype=torch.int32, device=BG0.device)
    false = torch.zeros(batch, dtype=torch.bool, device=BG0.device)
    zero = torch.zeros_like(BG0)
    state = EnvState(patient=patient, sensor=sensor, scenario=scenario, cgm_window=window,
                     window_len=ints + 1, done=false, episode_step=ints, key=key)
    result = StepResult(observation=Observation(CGM=CGM_obs), reward=zero, done=false, CHO=zero,
                        insulin=zero, BG=BG0, CGM=CGM_hist0, LBGI=LBGI, HBGI=HBGI, risk=risk)
    return state, result


def _as_dtype(x, like: torch.Tensor) -> torch.Tensor:
    """A controller's output as a tensor of ``like``'s dtype and device (a
    number becomes a filled tensor, not a copy to the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def env_step(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action: CtrlAction,
    reward_fun: Callable = risk_diff_reward,
    scenario_regen: bool = True,
):
    """One env step of every env: ``(state, StepResult)``.

    ``scenario_regen=False`` skips the candidate next-day plan of the
    'random' scenario: exact while the redraw is caught up before a meal
    slot can open (every slot lies in 05:00-23:00), as
    :func:`~simglucose_tpu_torch.envs.rollout.autoreset_step_with_candidate`
    does at a chunk boundary."""
    dtype = state.patient.x.dtype
    st = cfg.sample_time
    p = params.patient
    x = state.patient.x

    # the pump's quantization is the same for every minute of the step
    basal = pump_basal(params.pump, _as_dtype(action.basal, x))
    bolus = pump_bolus(params.pump, _as_dtype(action.bolus, x))
    insulin_rate = basal + bolus

    t0 = state.patient.t
    scenario = state.scenario
    if cfg.scenario_mode == "random":
        if scenario_regen:
            scenario, meals = scenario_meals_for_step(scenario, t0, st, dtype=dtype)
        else:
            meals = scenario_lookup_for_step(scenario, t0, st)
    elif cfg.scenario_mode == "exogenous":
        seq = params.meal_seq
        # a slice clamped into the sequence, as jax.lax.dynamic_slice clamps
        start = torch.clamp(t0, 0, seq.shape[-1] - st).to(torch.int64)
        idx = start[..., None] + torch.arange(st, device=t0.device)
        meals = torch.gather(seq.expand(idx.shape[:-1] + seq.shape[-1:]), -1, idx)
    elif cfg.scenario_mode == "custom":
        meals = custom_meals_for_step(params.custom_times, params.custom_amounts, t0, st)
    elif cfg.scenario_mode == "none":
        meals = torch.zeros(t0.shape + (st,), dtype=dtype, device=x.device)
    else:
        raise ValueError(f"unknown scenario_mode {cfg.scenario_mode!r} (the 'xs' modes are not ported)")
    meals = meals.to(dtype)

    patient = state.patient
    sensor = state.sensor
    noise_seq = _noise_seq(cfg, params)
    fst = float(st)
    CHO_avg = ins_avg = BG_avg = CGM_avg = torch.zeros_like(x[..., 0])
    for i in range(st):
        patient = patient_step(patient, p, PatientAction(CHO=meals[..., i], insulin=insulin_rate),
                               substeps=cfg.substeps, method=cfg.method)
        BG_i = observe_gsub(patient.x, p)
        if i == st - 1:  # the patient clock hits a multiple of sample_time
            sensor, CGM_i = sensor_sample(params.sensor, st, sensor, BG_i, noise_seq)
        else:
            CGM_i = sensor.last_CGM  # zero-order hold
        # the reference's op order, acc += v / sample_time (IEEE divisions)
        CHO_avg = CHO_avg + meals[..., i] / fst
        ins_avg = ins_avg + insulin_rate / fst
        BG_avg = BG_avg + BG_i / fst
        CGM_avg = CGM_avg + CGM_i / fst

    LBGI, HBGI, risk = risk_scalar(BG_avg)
    window = torch.cat([state.cgm_window[..., 1:], CGM_avg[..., None]], dim=-1)
    window_len = torch.clamp(state.window_len + 1, max=cfg.window_size)
    reward = _as_dtype(reward_fun(window, window_len), x)
    done = (BG_avg < cfg.bg_done_low) | (BG_avg > cfg.bg_done_high)

    new_state = EnvState(patient=patient, sensor=sensor, scenario=scenario, cgm_window=window,
                         window_len=window_len, done=done, episode_step=state.episode_step + 1,
                         key=state.key)
    result = StepResult(observation=Observation(CGM=CGM_avg), reward=reward, done=done,
                        CHO=CHO_avg, insulin=ins_avg, BG=BG_avg, CGM=CGM_avg, LBGI=LBGI,
                        HBGI=HBGI, risk=risk)
    return new_state, result
