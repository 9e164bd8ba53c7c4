"""The T1D patient in PyTorch: the meal state machine and the one-minute
ODE advance.

Counterpart of ``simglucose_tpu/models/patient.py:25-128``, built on
:mod:`simglucose_tpu_torch.models.uva_padova`.  The eating state machine is
branchless ``torch.where`` updates over :class:`PatientState`, batch-native
over the patients' leading axes.  ``_demo`` (the open-loop plot) is ROADMAP
queue 1 item 12.
"""
from __future__ import annotations

from typing import Optional

import torch

from simglucose_tpu_torch.core.types import PatientAction, PatientParams, PatientState
from simglucose_tpu_torch.models.uva_padova import EAT_RATE, integrate_minute
from simglucose_tpu_torch.ops.streams import SITE_INIT_BG, normals


def patient_init(
    params: PatientParams,
    key: Optional[torch.Tensor] = None,
    random_init_bg: bool = False,
    init_state: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    z: Optional[torch.Tensor] = None,
) -> PatientState:
    """The initial patient state (``x0``, or ``init_state``).

    With ``random_init_bg`` the glucose states x3, x4, x12 become
    N(x0_i, 0.1 x0_i), as in the reference, from the normals ``z``
    ``[..., 3]``, or, without them, from ``key``'s stream (site
    ``SITE_INIT_BG``)."""
    x0 = (params.x0 if init_state is None else init_state).to(dtype)
    if random_init_bg:
        if z is None:
            if key is None:
                raise ValueError("random_init_bg=True needs a key (or the normals z)")
            z = normals(key, SITE_INIT_BG, 3, dtype)
        x0 = x0.clone()
        for j, i in enumerate((3, 4, 12)):
            mean = x0[..., i].clone()
            x0[..., i] = mean + torch.sqrt(0.1 * mean) * z[..., j]
    zeros = torch.zeros_like(x0[..., 0])
    return PatientState(
        x=x0,
        planned_meal=zeros,
        last_CHO=zeros,
        is_eating=torch.zeros(zeros.shape, dtype=torch.bool, device=zeros.device),
        # the reference seeds last_Qsto with the initial stomach content
        last_Qsto=x0[..., 0] + x0[..., 1],
        last_foodtaken=zeros,
        t=torch.zeros(zeros.shape, dtype=torch.int32, device=zeros.device),
    )


def announce_meal(planned_meal: torch.Tensor, new_CHO: torch.Tensor):
    """Queue announced CHO and release it at EAT_RATE g/min.  Returns
    ``(to_eat, remaining_queue)``."""
    planned = planned_meal + new_CHO
    to_eat = torch.where(planned > 0, torch.clamp(planned, max=EAT_RATE), 0.0)
    planned = torch.clamp(planned - to_eat, min=0.0)
    return to_eat, planned


def patient_step(
    state: PatientState,
    params: PatientParams,
    action: PatientAction,
    substeps: int = 2,
    method: str = "rk45",
) -> PatientState:
    """Advance the patients by one minute, in the reference's order: meal
    announcement, eating start (snapshot of the stomach), food taken, eating
    end, then the ODE with the inputs held for the minute."""
    to_eat, planned = announce_meal(state.planned_meal, action.CHO)

    starts = (to_eat > 0) & (state.last_CHO <= 0)
    qsto_now = state.x[..., 0] + state.x[..., 1]
    last_Qsto = torch.where(starts, qsto_now, state.last_Qsto)
    foodtaken = torch.where(starts, 0.0, state.last_foodtaken)
    is_eating = starts | state.is_eating
    foodtaken = torch.where(is_eating, foodtaken + to_eat, foodtaken)
    ends = (to_eat <= 0) & (state.last_CHO > 0)
    is_eating = is_eating & ~ends

    d_mg = to_eat * 1000.0  # g/min -> mg/min
    insulin_rate = action.insulin * 6000.0 / params.BW  # U/min -> pmol/kg/min
    Dbar = last_Qsto + foodtaken * 1000.0  # mg

    x = integrate_minute(state.x, params, d_mg, insulin_rate, Dbar, substeps=substeps, method=method)
    return PatientState(
        x=x,
        planned_meal=planned,
        last_CHO=to_eat,
        is_eating=is_eating,
        last_Qsto=last_Qsto,
        last_foodtaken=foodtaken,
        t=state.t + 1,
    )
