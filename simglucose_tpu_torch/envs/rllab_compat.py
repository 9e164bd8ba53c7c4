"""rllab compatibility shim.

Counterpart of ``simglucose_tpu/envs/rllab_compat.py``.  The reference
exposes its step results through rllab's ``Step`` convenience constructor
when rllab is installed, and otherwise defines an identical namedtuple
fallback (reference: simulation/env.py:9-20).  This module provides the same
surface, plus a converter from the port's single-env
:class:`~simglucose_tpu_torch.core.types.StepResult`, whose 0-d tensors
become Python floats and bools.
"""
from __future__ import annotations

from collections import namedtuple

from simglucose_tpu_torch.core.types import Observation

_Step = namedtuple("Step", ["observation", "reward", "done", "info"])


def Step(observation, reward, done, **kwargs):
    """rllab-style step tuple: extra diagnostics go into ``info`` as kwargs
    (reference: simulation/env.py:13-20)."""
    return _Step(observation, reward, done, kwargs)


def step_result_to_rllab(
    res, sample_time=None, patient_name=None, patient_state=None, time=None
) -> _Step:
    """Convert a single-env :class:`StepResult` to the rllab ``Step`` tuple
    the reference's ``T1DSimEnv.step`` returns, info keys included
    (reference: simulation/env.py:106-117).  Each tensor field is read to
    the host as a Python float (``done`` a bool); the observation keeps its
    record, ``Observation(CGM=float)``."""
    return Step(
        observation=Observation(CGM=float(res.observation.CGM)),
        reward=float(res.reward),
        done=bool(res.done),
        sample_time=sample_time,
        patient_name=patient_name,
        meal=float(res.CHO),
        patient_state=patient_state,
        time=time,
        bg=float(res.BG),
        lbgi=float(res.LBGI),
        hbgi=float(res.HBGI),
        risk=float(res.risk),
    )
