"""Dict-style parameter lookups by patient name (reference: utils.py:10-27).

Counterpart of ``simglucose_tpu/utils/__init__.py:7-23``, on the port's own
parameter tables; with the profiling helpers of :mod:`.profiling`.  Nothing here imports pandas: ``lookup_patient_meta_data``
takes the caller's DataFrame.
"""
from __future__ import annotations

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.utils.profiling import Throughput, device_trace


def fetch_patient_params(name: str) -> dict:
    """All 61 parameter columns for one patient as a dict
    (reference: utils.py:10-14)."""
    return tables.patient_record(name)


def fetch_patient_quest(name: str) -> dict:
    """Quest therapy row (CR/CF/Age/TDI) for one patient, with the
    'Average'-patient fallback (reference: utils.py:17-21,
    basal_bolus_ctrller.py:59-62)."""
    return tables.quest_record(name)


def lookup_patient_meta_data(df, name: str) -> dict:
    """Row lookup by Name in any patient-keyed DataFrame
    (reference: utils.py:24-27)."""
    return df[df.Name == name].squeeze().to_dict()
