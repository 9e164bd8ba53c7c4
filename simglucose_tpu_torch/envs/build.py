"""Turn the parameter tables into an env config and params.

Counterpart of ``simglucose_tpu/envs/build.py:20-109``: resolve patient,
sensor and pump names into the packed parameter records and a static
:class:`~simglucose_tpu_torch.envs.functional.EnvConfig`, on ``device``
(default ``"cuda"``, which raises where CUDA is absent).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.core.types import tree_map
from simglucose_tpu_torch.envs.functional import EnvConfig, EnvParams
from simglucose_tpu_torch.params import cohort_names  # noqa: F401  (the JAX module's name)

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """float32 / float64 given as a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype)]


def make_env(
    patient_names: Union[str, int, Sequence],
    sensor: str = "Dexcom",
    pump: str = "Insulet",
    dtype=torch.float32,
    batch: bool = False,
    substeps: int = 1,
    method: str = "rk4",
    noise_seq: Optional[np.ndarray] = None,
    meal_seq: Optional[np.ndarray] = None,
    custom_times: Optional[np.ndarray] = None,
    custom_amounts: Optional[np.ndarray] = None,
    scenario_mode: Optional[str] = None,
    random_init_bg: bool = False,
    device="cuda",
):
    """``(EnvConfig, EnvParams)`` for one patient or a batch.

    With ``batch=False`` and one name the parameter leaves are 0-d (one
    env); with ``batch=True`` they keep the leading ``[B]`` axis and the
    sensor, pump and sequence leaves are broadcast to it.  ``noise_seq``
    selects the exogenous noise mode, ``meal_seq`` the exogenous scenario
    (unless ``scenario_mode`` says otherwise).  ``method='rk4'`` at one
    substep is the fast native integrator; reference parity takes
    ``method='rk45', substeps=4``."""
    device = check_device(device)
    dtype = torch_dtype(dtype)
    patient = tables.load_patient_params(patient_names, dtype=dtype, device=device)
    B = patient.BW.shape[0]
    if scenario_mode is None:
        scenario_mode = "exogenous" if meal_seq is not None else "random"
    cfg = EnvConfig(
        sample_time=tables.sensor_sample_time(sensor),
        substeps=substeps,
        method=method,
        noise_mode="exogenous" if noise_seq is not None else "native",
        scenario_mode=scenario_mode,
        random_init_bg=random_init_bg,
    )
    sensor_p = tables.load_sensor_params(sensor, dtype=dtype, device=device)
    pump_p = tables.load_pump_params(pump, dtype=dtype, device=device)

    def arr(x, dt=dtype):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    seqs = dict(noise_seq=arr(noise_seq), meal_seq=arr(meal_seq),
                custom_times=arr(custom_times, torch.int32), custom_amounts=arr(custom_amounts))
    if batch:
        sensor_p = tree_map(lambda a: a.expand(B), sensor_p)
        pump_p = tree_map(lambda a: a.expand(B), pump_p)
        seqs = {k: None if v is None else v.expand((B,) + v.shape) for k, v in seqs.items()}
    else:
        if B != 1:
            raise ValueError("batch=False requires a single patient name")
        patient = tree_map(lambda a: a[0], patient)
    return cfg, EnvParams(patient=patient, sensor=sensor_p, pump=pump_p, **seqs)

