"""The UVA/Padova 2008 patient, Quest therapy, sensor and pump tables of
simglucose v0.2.2, read from the raw JSON files in the repository."""
from __future__ import annotations

import json
import os

import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "simglucose_tpu_torch", "params", "data")
# the kinetic parameters of one patient, besides x0_1..x0_13
PATIENT_FIELDS = ("BW", "EGPb", "Gb", "Ib", "kabs", "kmax", "kmin", "b", "d", "Vg", "Vi", "Vmx",
                  "Km0", "k2", "k1", "p2u", "m1", "m2", "m4", "m30", "ki", "kp1", "kp2", "kp3",
                  "f", "ke1", "ke2", "Fsnc", "Vm0", "kd", "ksc", "ka1", "ka2", "u2ss")


def records(table: str) -> list:
    with open(os.path.join(DATA, f"{table}.json")) as f:
        return json.load(f)["records"]


def by_name(table: str) -> dict:
    return {r["Name"]: r for r in records(table)}


def patient_names() -> list:
    return [r["Name"] for r in records("vpatient")]


def patients(names, device, dtype=torch.float32) -> dict:
    """Per-patient columns ``[B]`` of the named patients: the kinetic
    parameters, ``x0`` as 13 columns, the basal rate u2ss * BW / 6000 in
    U/min (in ``dtype``), and the Quest CR and CF."""
    pt, q = by_name("vpatient"), by_name("quest")
    col = lambda table, c: torch.tensor([float(table[n][c]) for n in names], dtype=torch.float64,
                                        device=device).to(dtype)
    out = {c: col(pt, c) for c in PATIENT_FIELDS}
    out["x0"] = [col(pt, f"x0_{i}") for i in range(1, 14)]
    out["basal"] = out["u2ss"] * out["BW"] / 6000.0
    out["CR"], out["CF"] = col(q, "CR"), col(q, "CF")
    return out
