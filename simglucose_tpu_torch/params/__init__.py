"""Parameter tables and loaders of the port.

Counterpart of ``simglucose_tpu/params/__init__.py:28-174``.  The tables
are the port's own copy of the JAX package's ``params/data/*.json`` (the
same bytes, in ``simglucose_tpu_torch/params/data/``).  Loaders return
:mod:`simglucose_tpu_torch.core.types` records of tensors batched over the
requested patients, on ``device`` (default ``"cuda"``, which raises where
CUDA is absent; pass ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.core.types import (
    PatientParams,
    PumpParams,
    QuestParams,
    SensorParams,
)

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# Quest fallback for unknown patient names
# (reference: controller/basal_bolus_ctrller.py:59-62)
AVERAGE_QUEST = {"Name": "Average", "CR": 1 / 15, "CF": 1 / 50, "TDI": 50, "Age": 30}
AVERAGE_U2SS = 1.43  # pmol/(L*kg)
AVERAGE_BW = 57.0  # kg


@lru_cache(maxsize=None)
def load_table(table: str) -> tuple:
    """Raw records of 'vpatient', 'quest', 'sensor' or 'pump'."""
    with open(os.path.join(_DATA_DIR, f"{table}.json")) as f:
        return tuple(json.load(f)["records"])


def _by_name(table: str) -> dict:
    return {rec["Name"]: rec for rec in load_table(table)}


def patient_names() -> List[str]:
    """All 30 virtual patient names (adolescent/adult/child #001-#010)."""
    return [rec["Name"] for rec in load_table("vpatient")]


def cohort_names(n: int) -> List[str]:
    """The 30-patient cohort cycled out to ``n`` entries (the JAX package
    keeps this in ``envs/build.py:105``)."""
    base = patient_names()
    return [base[i % len(base)] for i in range(n)]


def sensor_names() -> List[str]:
    return [rec["Name"] for rec in load_table("sensor")]


def pump_names() -> List[str]:
    return [rec["Name"] for rec in load_table("pump")]


def patient_record(name: str) -> dict:
    return dict(_by_name("vpatient")[name])


def quest_record(name: str) -> dict:
    """Quest record; unknown names fall back to the 'Average' patient."""
    return dict(_by_name("quest").get(name, AVERAGE_QUEST))


def _resolve_names(names: Union[str, int, Sequence]) -> List[str]:
    """A name, an id (1-30) or a sequence of them -> list of names."""
    if isinstance(names, (str, int, np.integer)):
        names = [names]
    all_names = patient_names()
    out = []
    for n in names:
        if isinstance(n, (int, np.integer)):
            if not 1 <= int(n) <= len(all_names):
                raise ValueError(f"patient id must be in 1..{len(all_names)}, got {n}")
            out.append(all_names[int(n) - 1])
        else:
            out.append(str(n))
    return out


def _tensor(values, dtype, device):
    return torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=dtype,
                           device=check_device(device))


def load_patient_params(
    names: Union[str, int, Sequence], dtype=torch.float32, device="cuda"
) -> PatientParams:
    """Batched :class:`PatientParams` (``x0`` is ``[B, 13]``, others ``[B]``)."""
    names = _resolve_names(names)
    table = _by_name("vpatient")
    rows = []
    for n in names:
        if n not in table:
            raise KeyError(
                f"unknown patient {n!r}; valid names: {patient_names()[:3]}..."
            )
        rows.append(table[n])

    def col(c):
        return _tensor([r[c] for r in rows], dtype, device)

    x0 = torch.stack([col(f"x0_{i}") for i in range(1, 14)], dim=-1)
    return PatientParams(
        x0=x0, **{f: col(f) for f in PatientParams._fields if f != "x0"}
    )


def load_quest_params(
    names: Union[str, int, Sequence], dtype=torch.float32, device="cuda"
) -> QuestParams:
    """Batched Quest therapy params with the 'Average' fallback."""
    recs = [quest_record(n) for n in _resolve_names(names)]
    return QuestParams(
        *(_tensor([r[c] for r in recs], dtype, device) for c in QuestParams._fields)
    )


def sensor_record(name: str) -> dict:
    return dict(_by_name("sensor")[name])


def load_sensor_params(name: str, dtype=torch.float32, device="cuda") -> SensorParams:
    """Scalar SensorParams of one sensor (``sample_time`` via
    :func:`sensor_sample_time`)."""
    rec = sensor_record(name)
    cols = dict(PACF="PACF", gamma="gamma", lam="lambda", delta="delta",
                xi="xi", min="min", max="max")
    return SensorParams(
        **{k: _tensor(rec[c], dtype, device) for k, c in cols.items()}
    )


def sensor_sample_time(name: str) -> int:
    """CGM sampling period in minutes (Dexcom=3, GuardianRT=5, Navigator=1)."""
    return int(sensor_record(name)["sample_time"])


def pump_record(name: str) -> dict:
    return dict(_by_name("pump")[name])


def load_pump_params(name: str, dtype=torch.float32, device="cuda") -> PumpParams:
    rec = pump_record(name)
    return PumpParams(
        *(_tensor(rec[c], dtype, device) for c in PumpParams._fields)
    )
