"""Results frame of a cohort simulation, without jax.

The counterpart of ``simglucose_tpu/analysis/report.py:139-153``
(``cohort_frame``), whose JAX version maps over its inputs with
``jax.tree.map``.  The per-patient frame and the analysis report are the
shared ``simglucose_tpu.analysis.report.trajectory_frame``/``report``,
which import pandas and matplotlib only when called.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from simglucose_tpu.analysis.report import report, trajectory_frame

__all__ = ["cohort_frame", "report", "trajectory_frame"]


def cohort_frame(reset_res, traj, patient_names: Sequence[str], start_time, sample_time: int):
    """``[B]`` reset row + ``[T, B]`` trajectory NamedTuples (fields BG, CGM,
    CHO, insulin, LBGI, HBGI, risk) -> the (patient, Time) multi-indexed
    frame that ``report`` consumes."""
    import pandas as pd

    frames = []
    for i in range(len(patient_names)):
        r = type(reset_res)(*(np.asarray(a)[i] for a in reset_res))
        tr = type(traj)(*(np.asarray(a)[:, i] for a in traj))
        frames.append(trajectory_frame(r, tr, start_time, sample_time))
    return pd.concat(frames, keys=patient_names)
