"""Cohort simulation engine of the port: ``simulate()`` on the K1a kernel.

Counterpart of the kernel branch of ``simglucose_tpu/sim/engine.py``
(``_pallas_eligible`` :106-153, ``_pallas_horizon`` :182-190, ``_pallas_cfg``
:193-267, ``_simulate_pallas`` :487-644, ``simulate`` :647-800), split in
two so the core runs where pandas is not installed:

* :func:`simulate_cohort` runs the rollout and returns numpy planes: the
  reset row, the ``[T, B]`` BG/CGM/CHO/insulin/LBGI/HBGI/Risk planes and the
  reward plane.
* :func:`simulate` adds the reference-style results DataFrame,
  ``df.attrs['reward']`` and the ``save_path`` CSVs and report.

Both run on ``device`` (default ``"cuda"``, which raises where CUDA is
absent; ``"cpu"`` runs the plain PyTorch version).  Configs the JAX package
sends to its general XLA engine raise ``NotImplementedError``: that engine
is ported later (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from datetime import datetime, timedelta
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis.risk import risk_diff_reward, risk_scalar
from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.envs.functional import replay_rewards, reward_history, reward_window_size
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops.rollout import (
    LANES,
    config_for_sensor,
    pack_params,
    rollout,
)
from simglucose_tpu_torch.scenario.meal import MealSpec, parse_meal_times

logger = logging.getLogger(__name__)

# Longest horizon (env steps) of one kernel call.  Longer horizons run as
# calls of this many steps that thread the persistent state, so device
# memory is bounded by one call's trajectory; the counter-based generator
# makes the chunked run equal the single call.
MAX_STEPS_PER_CALL = 4096

_XLA_ITEM = "the general eager env path, ROADMAP queue 1 item 6"
# controller kwargs each built-in controller accepts (JAX engine :140-141)
_KNOWN_KW = {"BB": {"target"}, "BASAL-BOLUS": {"target"}, "PID": {"P", "I", "D", "target"}}


class FrameFields(NamedTuple):
    """The fields ``trajectory_frame``/``cohort_frame`` read."""

    BG: np.ndarray
    CGM: np.ndarray
    CHO: np.ndarray
    insulin: np.ndarray
    LBGI: np.ndarray
    HBGI: np.ndarray
    risk: np.ndarray


class CohortResult(NamedTuple):
    """Numpy planes of one cohort simulation."""

    reset: FrameFields  # [B] each: the reset row
    traj: FrameFields  # [T, B] each
    reward: np.ndarray  # [T, B]
    sample_time: int


def _controller_spec(controller):
    """Normalize a controller spec to (name_or_None_or_object, kwargs)."""
    if isinstance(controller, dict) and len(controller) == 1:
        (name, kwargs), = controller.items()
        return name, dict(kwargs)
    if (
        isinstance(controller, tuple)
        and len(controller) == 2
        and isinstance(controller[0], str)
        and isinstance(controller[1], dict)
    ):
        return controller[0], dict(controller[1])
    return controller, {}


def check_eligible(controller, *, animate: bool = False, substeps: int = 1, dtype=np.float32,
                   compat_mode: bool = False, engine: str = "auto") -> None:
    """Raise for what only the JAX package's XLA engine runs today: the
    rollout kernel takes ``'BB'``, ``'PID'`` (optionally with kwargs) or
    None (BB), float32, rk4 with one substep."""
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError(f"engine must be 'auto', 'xla', or 'pallas'; got {engine!r}")
    if engine == "xla":
        raise NotImplementedError(f"engine='xla' is {_XLA_ITEM}")
    if compat_mode:
        raise NotImplementedError(f"compat_mode (float64, rk45, MT19937 streams) is {_XLA_ITEM}")
    if animate:
        raise NotImplementedError(f"animate=True is {_XLA_ITEM}")
    if substeps != 1:
        raise NotImplementedError(f"substeps={substeps} is {_XLA_ITEM} (the kernel is rk4, 1 substep)")
    if dtype not in (np.float32, torch.float32):
        raise NotImplementedError(f"dtype={dtype} is {_XLA_ITEM} (the kernel is float32)")
    name, kwargs = _controller_spec(controller)
    if name is None:
        return
    if not isinstance(name, str):
        raise NotImplementedError(f"a custom controller is {_XLA_ITEM}")
    if name.upper() not in _KNOWN_KW:
        raise ValueError(f"controller must be 'BB' or 'PID' (optionally with kwargs); got {name!r}")
    extra = set(kwargs) - _KNOWN_KW[name.upper()]
    if extra:
        raise ValueError(f"controller {name!r} takes no arguments {sorted(extra)}")


def _call_steps(n_steps: int):
    """Steps of each kernel call: MAX_STEPS_PER_CALL each, the last call
    the remainder (the kernel takes its length at run time, so a shorter
    last call costs no rebuild)."""
    m = MAX_STEPS_PER_CALL
    return [min(m, n_steps - s) for s in range(0, n_steps, m)]


def kernel_config(cgm_name: str, insulin_pump_name: str, controller, n_steps: int,
                  start_min: int = 0, random_init_bg: bool = False, *,
                  start_time: Optional[datetime] = None, scenario=None):
    """The rollout configuration of a closed-loop BB / PID run over
    ``n_steps`` steps: the sensor's and the pump's rows, a fixed horizon
    (no auto-reset) from minute ``start_min`` of the day, random meals or
    the custom ``scenario`` (a list of (time, grams), times read from
    ``start_time``)."""
    pump = tables.pump_record(insulin_pump_name)
    name, kwargs = _controller_spec(controller)
    fields = {}
    if isinstance(name, str) and name.upper() == "PID":
        gains = dict(P=-1e-4, I=-1e-7, D=0.0, target=140.0)
        gains.update(kwargs)
        fields = dict(
            controller="pid", pid_p=float(gains["P"]), pid_i=float(gains["I"]),
            pid_d=float(gains["D"]), pid_target=float(gains["target"]),
        )
    else:
        fields = dict(controller="bb")
        if "target" in kwargs:
            fields["bb_target"] = float(kwargs["target"])
    if scenario is not None and not isinstance(scenario, str):
        # a CustomScenario is the kernel's static schedule in episode minutes
        t_arr, a_arr = parse_meal_times(scenario, start_time)
        fields.update(
            scenario_kind="static",
            det_meal_times=tuple(int(t) for t in t_arr),
            det_meal_amounts=tuple(float(a) for a in a_arr),
        )
    elif scenario not in (None, "random"):
        raise ValueError(f"scenario must be None, 'random' or a list of (time, grams); got {scenario!r}")
    cfg = config_for_sensor(
        cgm_name,
        n_steps=n_steps,
        inc_basal=float(pump["inc_basal"]),
        min_basal=float(pump["min_basal"]),
        max_basal=float(pump["max_basal"]),
        inc_bolus=float(pump["inc_bolus"]),
        min_bolus=float(pump["min_bolus"]),
        max_bolus=float(pump["max_bolus"]),
        random_init_bg=random_init_bg,
        autoreset=False,
        fixed_start_min=start_min,
        **fields,
    )
    return cfg


def _finish(planes, reward_fun, window_size, history):
    """``[4, T, B]`` BG/CGM/CHO/insulin -> ``[8, T, B]`` with the
    LBGI/HBGI/risk planes of BG and the reward replayed from CGM, on the
    planes' device; and the reward history after the last step."""
    rewards, history = replay_rewards(reward_fun, window_size, history, planes[1])
    return torch.cat([planes, torch.stack([*risk_scalar(planes[0]), rewards])]), history


def simulate_cohort(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    animate: bool = False,
    parallel: bool = True,  # accepted for API familiarity; always one kernel
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    device="cuda",
) -> CohortResult:
    """Closed-loop cohort simulation on the rollout kernel -> numpy planes.

    Arguments are :func:`simulate`'s.  Fixed horizon, no auto-reset (the
    reference batch_sim semantics).  The random streams are keyed by
    (scenario_seed, cgm_seed), each 0 when omitted.  Rewards are recomputed
    from the CGM planes with the environment's window law, so any
    window-based ``reward_fun`` applies."""
    del parallel
    check_eligible(controller, animate=animate, substeps=substeps, dtype=dtype,
                   compat_mode=compat_mode, engine=engine)
    device = check_device(device)
    if patient_names is None:
        patient_names = tables.patient_names()
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    B = len(patient_names)
    if start_time is None:
        start_time = datetime(2018, 1, 1, 0, 0, 0)
    st = tables.sensor_sample_time(cgm_name)
    n_steps = int(sim_time.total_seconds() // 60) // st
    if n_steps < 1:
        raise ValueError(f"sim_time {sim_time} is shorter than one {st}-min sample")
    start_min = (start_time.hour * 60 + start_time.minute) % 1440
    cfg = kernel_config(
        cgm_name, insulin_pump_name, controller, n_steps, start_min, random_init_bg,
        start_time=start_time, scenario=scenario,
    )
    # the packed layout is [50, rows, 128]: pad the cohort by cycling names
    padded = -(-B // LANES) * LANES
    names_p = [patient_names[i % B] for i in range(padded)]
    patient = tables.load_patient_params(names_p, device=device)
    quest = tables.load_quest_params(names_p, device=device)
    packed = pack_params(patient, basal_rate(patient), quest=quest)
    key = (scenario_seed or 0, cgm_seed or 0)
    W = reward_window_size(st)

    tic = time.perf_counter()
    # Each call's BG/CGM/CHO/insulin planes are finished (risk planes and
    # rewards appended) on the device and go to the host in one copy, so
    # device memory holds one call's trajectory however long the horizon;
    # the reward window's history carries from call to call.  On the CPU,
    # torch rounds log/pow differently in its vectorised loop and in the
    # scalar tail, so the same BG would take other ulps in other call
    # shapes: there the planes are finished once over the whole horizon,
    # and a chunked run stays bit-equal to one call.
    per_call = device.type == "cuda"
    host = []
    state = history = None
    offset = 0
    for steps in _call_steps(n_steps):
        traj = rollout(
            dataclasses.replace(cfg, n_steps=steps), packed, key,
            state=state, init=int(offset == 0), step_offset=offset,
        )
        state = (traj["state_f"], traj["state_i"])
        planes = torch.stack([traj[k][:, :B] for k in ("BG", "CGM", "CHO", "insulin")])
        if offset == 0:
            bg0, cgm0 = traj["BG0"][:B], traj["CGM0"][:B]
            reset = torch.stack([bg0, cgm0, *risk_scalar(bg0)]).cpu()
            history = reward_history(W, cgm0)
        if per_call:
            planes, history = _finish(planes, reward_fun, W, history)
        host.append(planes.cpu())
        offset += steps
    out = torch.cat(host, dim=1)
    if not per_call:
        out, _ = _finish(out, reward_fun, W, history)
    out = out.numpy()
    logger.info(
        "Simulation of %d patients x %s took %.3f s (rollout kernel, %s)",
        B, sim_time, time.perf_counter() - tic, device,
    )
    reset = reset.numpy()
    zeros = np.zeros(B, np.float32)
    return CohortResult(
        reset=FrameFields(reset[0], reset[1], zeros, zeros, *reset[2:]),
        traj=FrameFields(*out[:7]),
        reward=out[7],
        sample_time=st,
    )


def simulate(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    save_path: Optional[str] = None,
    animate: bool = False,
    parallel: bool = True,
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    device="cuda",
):
    """Run a closed-loop cohort simulation and return the results frame.

    The JAX package's ``simulate`` (reference simulation/user_interface.py:
    303-385) on the port's rollout kernel: ``scenario`` None or 'random'
    draws per-patient random daily meal plans, a list of (time, grams) is a
    custom scenario for every patient; ``controller`` is 'BB' (default) or
    'PID', optionally with kwargs (``('PID', dict(P=..., I=..., D=...,
    target=...))``).  Returns the (patient, Time) multi-indexed frame with
    the per-step rewards ``[T, B]`` in ``df.attrs['reward']``; with
    ``save_path`` also writes per-patient CSVs and the analysis report.
    Needs pandas (and matplotlib for the report)."""
    from simglucose_tpu_torch.analysis.report import cohort_frame, report

    if patient_names is None:
        patient_names = tables.patient_names()
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    if start_time is None:
        start_time = datetime(2018, 1, 1, 0, 0, 0)
    res = simulate_cohort(
        sim_time=sim_time, scenario=scenario, scenario_seed=scenario_seed,
        controller=controller, patient_names=patient_names, cgm_name=cgm_name,
        cgm_seed=cgm_seed, insulin_pump_name=insulin_pump_name,
        start_time=start_time, animate=animate, parallel=parallel,
        random_init_bg=random_init_bg, dtype=dtype, substeps=substeps,
        reward_fun=reward_fun, engine=engine, compat_mode=compat_mode,
        device=device,
    )
    df = cohort_frame(res.reset, res.traj, patient_names, start_time, res.sample_time)
    df.attrs["reward"] = res.reward
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        for name in patient_names:
            df.loc[name].to_csv(os.path.join(save_path, f"{name}.csv"))
        report(df, save_path=save_path)
    return df
