"""Functional glucose controllers in PyTorch.

Counterpart of ``simglucose_tpu/controllers/functional.py``.  A controller
is a pair ``(init_state, policy)`` with

    policy(ctrl_state, result: StepResult) -> (ctrl_state, CtrlAction)

where ``result`` is the previous step's :class:`StepResult`.  Unlike the
JAX package's single-env policies, which the env layer vmaps, the port's
are batch-native: ``result``'s leaves are ``[B]`` tensors (the envs'
leading axes) and the policy returns ``[B]`` (or broadcastable) actions.
A state is either per env (leading batch axis) or shared and broadcast
(:func:`simglucose_tpu_torch.envs.rollout.broadcast_ctrl_state`).

* BB, the basal-bolus therapy (reference controller/basal_bolus_ctrller.py);
* PID on CGM (reference controller/pid_ctrller.py);
* a constant basal rate, for benchmarks.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.core.types import CtrlAction, PatientParams, QuestParams, StepResult

ControllerFn = Callable[[Any, StepResult], Tuple[Any, CtrlAction]]


class BBParams(NamedTuple):
    """Per-patient therapy constants of the basal-bolus controller."""

    basal: torch.Tensor  # u2ss * BW / 6000, U/min
    CR: torch.Tensor
    CF: torch.Tensor


def bb_params(patient: PatientParams, quest: QuestParams) -> BBParams:
    return BBParams(basal=patient.u2ss * patient.BW / 6000.0, CR=quest.CR, CF=quest.CF)


def _bb_action(bb: BBParams, result: StepResult, sample_time: int, target: float) -> CtrlAction:
    """bolus [U] = meal * dt / CR + 1[G > 150] (G - target) / CF, as U/min;
    ``meal`` is the previous step's CHO (g/min)."""
    glucose = result.observation.CGM
    meal = result.CHO
    bolus_u = (meal * sample_time) / bb.CR + (glucose > 150.0) * (glucose - target) / bb.CF
    bolus = torch.where(meal > 0, bolus_u / sample_time, 0.0)
    return CtrlAction(basal=bb.basal, bolus=bolus)


def bb_controller(bb: BBParams, sample_time: int, target: float = 140.0):
    """Basal-bolus therapy with the therapy constants closed over."""

    def policy(state, result: StepResult):
        return state, _bb_action(bb, result, sample_time, target)

    return (), policy


def bb_policy(sample_time: int, target: float = 140.0) -> ControllerFn:
    """Basal-bolus therapy with the constants carried IN the controller
    state (a :class:`BBParams` of per-patient tensors)."""

    def policy(bb: BBParams, result: StepResult):
        return bb, _bb_action(bb, result, sample_time, target)

    return policy


class PIDState(NamedTuple):
    integrated: torch.Tensor
    prev: torch.Tensor


def pid_controller(sample_time: int, P: float = 1.0, I: float = 0.0, D: float = 0.0,
                   target: float = 140.0, dtype=torch.float32, device="cuda"):
    """PID on CGM, emitted as basal; the control uses the previous
    integrated error, as the reference's update order does.  The initial
    state is shared (0-d tensors on ``device``)."""

    def policy(state: PIDState, result: StepResult):
        bg = result.observation.CGM
        control = P * (bg - target) + I * state.integrated + D * (bg - state.prev) / sample_time
        new_state = PIDState(integrated=state.integrated + (bg - target) * sample_time, prev=bg)
        return new_state, CtrlAction(basal=control, bolus=torch.zeros_like(control))

    zero = torch.zeros((), dtype=dtype, device=check_device(device))
    return PIDState(integrated=zero, prev=zero), policy


def constant_controller(basal: float, dtype=torch.float32, device="cuda"):
    """A fixed basal rate and no bolus: the open-loop benchmark policy."""
    device = check_device(device)
    action = CtrlAction(basal=torch.full((), basal, dtype=dtype, device=device),
                        bolus=torch.zeros((), dtype=dtype, device=device))

    def policy(state, result: StepResult):
        return state, action

    return (), policy
