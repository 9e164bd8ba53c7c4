"""Clinical evaluation of glucose controllers on the virtual cohort.

Counterpart of ``simglucose_tpu/rl/evaluate.py``: a trained policy
(:func:`evaluate_policy_kernel`, the rollout kernel's ``'nn'`` controller
K1b acting with the policy's mean action) and the clinical therapies
(:func:`evaluate_controller`, BB or PID on K1a) run over the same cohort
and report the reference's per-patient statistics (:func:`cohort_stats`:
time in range, LBGI / HBGI / risk index, BG summary; the quantities of the
reference's ``performance_stats.csv``).

Fixed horizon, no auto-reset (the reference's batch_sim protocol): a
glucose excursion stays in the trace and shows in the statistics.

Pairing: both functions pad the cohort to a multiple of 128 lanes by
cycling the names, take the pump, sensor and start minute of
``sim/engine.py::kernel_config``, and key the rollout's Philox streams by
``(seed, 0)``.  The kernels draw meals, sensor noise and initial states from
the same draw sites, keyed by the call's key and the lane, so a policy and a
therapy evaluated at one seed see identical meal scenarios and CGM noise.

Not here: ``policy_controller`` and custom ``(init, fn)`` controllers, which
run through the eager env path (ROADMAP queue 1 item 9); the TPU's
``interpret`` and ``t_chunk`` knobs; ``shard``, which comes with the
multi-device port (item 11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis.risk import risk_index
from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.sim import engine

PUMP = "Insulet"  # the pump of both evaluations (JAX config_for_sensor's default row)


def cohort_stats(bg: np.ndarray) -> dict:
    """Per-patient clinical statistics from a BG matrix ``[B, T]`` (mg/dL):
    time-in-zone percentages and whole-trace LBGI / HBGI / RI (horizon =
    T, the performance_stats.csv convention).  Numpy in, numpy out."""
    bg = np.asarray(bg)
    T = bg.shape[-1]
    LBGI, HBGI, RI = (x.numpy() for x in risk_index(torch.as_tensor(np.ascontiguousarray(bg)), T))
    return {
        "BG_mean": bg.mean(axis=-1),
        "BG_min": bg.min(axis=-1),
        "BG_max": bg.max(axis=-1),
        "percent_in_70_180": 100.0 * ((bg >= 70) & (bg <= 180)).mean(axis=-1),
        "percent_below_70": 100.0 * (bg < 70).mean(axis=-1),
        "percent_above_180": 100.0 * (bg > 180).mean(axis=-1),
        "percent_below_50": 100.0 * (bg < 50).mean(axis=-1),
        "percent_above_250": 100.0 * (bg > 250).mean(axis=-1),
        "LBGI": LBGI,
        "HBGI": HBGI,
        "risk_index": RI,
    }


def _lanes(patient_names):
    """(names, names padded cyclically to a multiple of 128 lanes)."""
    names = [patient_names] if isinstance(patient_names, str) else list(patient_names)
    padded = -(-len(names) // tr.LANES) * tr.LANES
    return names, [names[i % len(names)] for i in range(padded)]


def packed_cohort(names_p, device) -> torch.Tensor:
    """Packed patient planes with the Quest CR/CF planes (BB and the
    residual decoder dose from them) on ``device``."""
    patient = tables.load_patient_params(names_p, device=device)
    quest = tables.load_quest_params(names_p, device=device)
    return tr.pack_params(patient, basal_rate(patient), quest=quest)


def _n_steps(hours: float, sensor: str) -> int:
    n = int(hours * 60) // tables.sensor_sample_time(sensor)
    if n < 1:
        raise ValueError(f"hours={hours} is shorter than one {sensor} sample")
    return n


def controller_config(controller, sensor: str, n_steps: int, start_min: int = 0,
                      random_init_bg: bool = False) -> tr.RolloutConfig:
    """The rollout config of a BB / PID evaluation: ``simulate()``'s
    (``sim/engine.py::kernel_config``) over the whole horizon in one call."""
    return engine.kernel_config(sensor, PUMP, controller, n_steps, start_min, random_init_bg)


def policy_config(params, sensor: str, n_steps: int, start_min: int = 0,
                  random_init_bg: bool = False) -> tr.RolloutConfig:
    """The rollout config of a policy evaluation: the therapies' config
    with the ``'nn'`` controller at the params' width and decoder, acting
    with the policy's mean action (the environment stays stochastic)."""
    return dataclasses.replace(
        controller_config(None, sensor, n_steps, start_min, random_init_bg),
        controller="nn",
        nn_hidden=int(params.w1.shape[1]),
        nn_action_scale=float(params.action_scale),
        nn_scale_by_basal=bool(params.scale_by_basal),
        nn_decoder=params.decoder,
        nn_sample_actions=False,
    )


def _results(traj: dict, names: list) -> dict:
    B = len(names)
    plane = lambda k: np.ascontiguousarray(traj[k][:, :B].cpu().numpy().T)  # [B, T]
    bg = plane("BG")
    out = cohort_stats(bg)
    out["names"] = names
    out["BG"] = bg
    out["CGM"] = plane("CGM")
    out["insulin_mean"] = plane("insulin").mean(axis=-1)
    return out


def evaluate_controller(
    controller,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    device="cuda",
) -> dict:
    """Closed-loop cohort evaluation of a clinical therapy on the rollout
    kernel K1a: ``'BB'``, ``'PID'`` or ``('PID', {...})`` (gains ``P``,
    ``I``, ``D``, ``target``; BB takes ``target``).  A custom controller
    raises ``NotImplementedError`` (evaluation on the eager env path,
    ROADMAP queue 1 item 9).

    Returns :func:`cohort_stats` plus ``names``, the ``BG``/``CGM`` traces
    ``[B, T]`` and the per-patient mean insulin ``insulin_mean``.  Paired
    with :func:`evaluate_policy_kernel` at the same ``seed``."""
    engine.check_eligible(controller)
    device = check_device(device)
    names, names_p = _lanes(patient_names)
    cfg = controller_config(controller, sensor, _n_steps(hours, sensor), start_min, random_init_bg)
    traj = tr.rollout(cfg, packed_cohort(names_p, device), seed)
    return _results(traj, names)


def evaluate_policy_kernel(
    params,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    device="cuda",
) -> dict:
    """Closed-loop cohort evaluation of a trained policy on the rollout
    kernel K1b: the policy's mean action (no exploration noise) through the
    decoder its params carry (``decoder``, ``action_scale``,
    ``scale_by_basal``), the environment stochastic.  The trunk must be
    relu (``pack_policy_weights`` raises otherwise).

    Returns the dict of :func:`evaluate_controller`, paired with it at the
    same ``seed``."""
    device = check_device(device)
    names, names_p = _lanes(patient_names)
    cfg = policy_config(params, sensor, _n_steps(hours, sensor), start_min, random_init_bg)
    weights = tr.pack_policy_weights(params).to(device)
    traj = tr.rollout(cfg, packed_cohort(names_p, device), seed, weights=weights)
    return _results(traj, names)


def stats_frame(results: dict):
    """Per-patient stats dict -> pandas DataFrame, one row per patient (the
    reference's performance_stats.csv shape; pandas is imported here
    only)."""
    import pandas as pd

    cols = {k: v for k, v in results.items() if isinstance(v, np.ndarray) and v.ndim == 1}
    return pd.DataFrame(cols, index=results["names"])
