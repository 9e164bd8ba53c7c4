"""Parameter and state records of the port, as NamedTuples of tensors.

Counterpart of ``simglucose_tpu/core/types.py``.  Fields and their order
are the JAX package's, so a record means the same thing on both sides.
:func:`from_jax` converts the JAX package's records (any object with the
same class and field names, leaves passed through ``np.asarray``) into the
port's — this is how tests feed both sides identical parameters and states.

The one field that differs is ``key``: where the JAX states hold a threefry
PRNG key, the port's hold an int64 ``[..., 4]`` Philox key and counter
(seed words, lane, episode; :mod:`simglucose_tpu_torch.ops.streams`).  The
state records are batch-native: every leaf carries the env's leading batch
axes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device


class PatientParams(NamedTuple):
    """UVA/Padova kinetic parameters of a batch of virtual patients
    (x0 is ``[..., 13]``, every other field ``[...]``)."""

    x0: torch.Tensor
    BW: torch.Tensor
    EGPb: torch.Tensor
    Gb: torch.Tensor
    Ib: torch.Tensor
    kabs: torch.Tensor
    kmax: torch.Tensor
    kmin: torch.Tensor
    b: torch.Tensor
    d: torch.Tensor
    Vg: torch.Tensor
    Vi: torch.Tensor
    Vmx: torch.Tensor
    Km0: torch.Tensor
    k2: torch.Tensor
    k1: torch.Tensor
    p2u: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    m4: torch.Tensor
    m30: torch.Tensor
    ki: torch.Tensor
    kp1: torch.Tensor
    kp2: torch.Tensor
    kp3: torch.Tensor
    f: torch.Tensor
    ke1: torch.Tensor
    ke2: torch.Tensor
    Fsnc: torch.Tensor
    Vm0: torch.Tensor
    kd: torch.Tensor
    ksc: torch.Tensor
    ka1: torch.Tensor
    ka2: torch.Tensor
    u2ss: torch.Tensor


class QuestParams(NamedTuple):
    """Basal-bolus therapy parameters (Quest table)."""

    CR: torch.Tensor
    CF: torch.Tensor
    Age: torch.Tensor
    TDI: torch.Tensor


class SensorParams(NamedTuple):
    """CGM sensor noise constants; ``sample_time`` stays a Python int."""

    PACF: torch.Tensor
    gamma: torch.Tensor
    lam: torch.Tensor
    delta: torch.Tensor
    xi: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


class PumpParams(NamedTuple):
    """Insulin pump quantization parameters."""

    min_bolus: torch.Tensor
    max_bolus: torch.Tensor
    inc_bolus: torch.Tensor
    min_basal: torch.Tensor
    max_basal: torch.Tensor
    inc_basal: torch.Tensor


class PatientAction(NamedTuple):
    """Input of the physiological model."""

    CHO: torch.Tensor  # g/min carbohydrate eaten this minute
    insulin: torch.Tensor  # U/min


class CtrlAction(NamedTuple):
    """Controller output."""

    basal: torch.Tensor  # U/min
    bolus: torch.Tensor  # U/min


class Observation(NamedTuple):
    """Environment observation."""

    CGM: torch.Tensor  # mg/dL


class PatientState(NamedTuple):
    """The 13-state UVA/Padova ODE state and the meal bookkeeping."""

    x: torch.Tensor  # [..., 13]
    planned_meal: torch.Tensor  # g still queued, eaten at EAT_RATE
    last_CHO: torch.Tensor  # g/min eaten in the previous minute
    is_eating: torch.Tensor  # bool
    last_Qsto: torch.Tensor  # mg, stomach glucose at meal start
    last_foodtaken: torch.Tensor  # g eaten in the current meal
    t: torch.Tensor  # int32 minutes since episode start


class SensorState(NamedTuple):
    """CGM sensor: the streaming noise chain (AR(1) state, the 4 Johnson-SU
    lattice values around the current 15-min segment) and the last sample."""

    last_CGM: torch.Tensor
    e: torch.Tensor  # AR(1) state (before Johnson-SU)
    lattice: torch.Tensor  # [..., 4]
    seg: torch.Tensor  # int32 current 15-min segment
    lattice_next: torch.Tensor  # int32 next lattice point to draw
    sample_count: torch.Tensor  # int32 samples drawn so far
    key: torch.Tensor  # int64 [..., 4] Philox key and counter


class ScenarioState(NamedTuple):
    """Today's meal plan: 6 slots, minute of day (-1: skipped) and grams."""

    meal_times: torch.Tensor  # [..., 6]
    meal_amounts: torch.Tensor  # [..., 6]
    day: torch.Tensor  # int32 day the plan belongs to
    start_min: torch.Tensor  # int32 episode start minute of day
    key: torch.Tensor  # int64 [..., 4]


class EnvState(NamedTuple):
    """One closed-loop env per lane; ``cgm_window`` is the reward's
    last-hour CGM ring buffer (oldest first)."""

    patient: PatientState
    sensor: SensorState
    scenario: ScenarioState
    cgm_window: torch.Tensor  # [..., W]
    window_len: torch.Tensor  # int32 valid entries of cgm_window
    done: torch.Tensor  # bool
    episode_step: torch.Tensor  # int32
    key: torch.Tensor  # int64 [..., 4]


class StepResult(NamedTuple):
    """Outputs of one env step (or of a reset)."""

    observation: Observation
    reward: torch.Tensor
    done: torch.Tensor
    CHO: torch.Tensor
    insulin: torch.Tensor
    BG: torch.Tensor
    CGM: torch.Tensor
    LBGI: torch.Tensor
    HBGI: torch.Tensor
    risk: torch.Tensor


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped records (NamedTuples,
    tuples, lists); ``None`` leaves stay ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _record_classes() -> dict:
    from simglucose_tpu_torch.controllers.functional import BBParams, PIDState
    from simglucose_tpu_torch.envs.functional import EnvParams

    return {
        cls.__name__: cls
        for cls in (PatientParams, QuestParams, SensorParams, PumpParams, PatientAction,
                    CtrlAction, Observation, PatientState, SensorState, ScenarioState,
                    EnvState, StepResult, BBParams, PIDState, EnvParams)
    }


def from_jax(record, device="cuda", key: Optional[torch.Tensor] = None):
    """The port's record for a JAX-package record of the same class name.

    Each leaf goes through ``np.asarray`` and keeps its dtype, so a float64
    JAX record gives float64 tensors; nested records convert too, and
    ``None`` leaves stay ``None``.  The JAX states' threefry ``key`` leaves
    have no meaning here: records that carry one take the port's Philox key
    from ``key`` (an int64 ``[..., 4]`` tensor,
    :func:`~simglucose_tpu_torch.ops.streams.env_keys`), which it requires."""
    device = check_device(device)
    classes = _record_classes()

    def convert(rec):
        cls = classes.get(type(rec).__name__)
        if cls is None:
            raise TypeError(f"no port record for {type(rec).__name__}")
        vals = []
        for f in cls._fields:
            v = getattr(rec, f)
            if f == "key":
                if key is None:
                    raise ValueError(f"{cls.__name__} carries a PRNG key: pass key= (an int64 "
                                     "[..., 4] Philox key, ops.streams.env_keys)")
                vals.append(torch.as_tensor(key, dtype=torch.int64, device=device))
            elif v is None:
                vals.append(None)
            elif type(v).__name__ in classes:
                vals.append(convert(v))
            else:
                vals.append(torch.as_tensor(np.asarray(v), device=device))
        return cls(*vals)

    return convert(record)
