"""Clinical evaluation of glucose controllers on the virtual cohort.

Counterpart of ``simglucose_tpu/rl/evaluate.py``: a trained policy
(:func:`evaluate_policy_kernel`, the rollout kernel's ``'nn'`` controller
K1b acting with the policy's mean action, or :func:`policy_controller` on
the eager env path) and the clinical therapies (:func:`evaluate_controller`)
run over the same cohort and report the reference's per-patient statistics
(:func:`cohort_stats`: time in range, LBGI / HBGI / risk index, BG summary;
the quantities of the reference's ``performance_stats.csv``).

Fixed horizon, no auto-reset (the reference's batch_sim protocol): a
glucose excursion stays in the trace and shows in the statistics.

Two engines, and which evaluations are paired.  The JAX package runs every
controller on one engine, so any two controllers at one seed see the same
meals and sensor noise.  The port has two engines with streams of their
own (the same laws, not the same bits):

* the rollout kernels: ``evaluate_controller`` with ``'BB'`` / ``'PID'``
  (K1a, float32) and :func:`evaluate_policy_kernel` (K1b).  Both run
  ``simulate()``'s path, ``sim/engine.py::kernel_cohort``, in one call:
  the cohort padded to a multiple of 128 lanes by cycling the names, the
  pump, sensor and start minute of ``sim/engine.py::kernel_config``, the
  Philox streams keyed by ``(seed, 0)``.  So a policy and a therapy at
  one seed see identical meal scenarios and CGM noise, and BB here is
  ``simulate_cohort``'s at ``scenario_seed=seed, cgm_seed=0``.
* the eager env path: ``evaluate_controller`` with an ``(init, fn)`` pair
  or ``(init, fn, in_axes)`` triple (such as :func:`policy_controller`'s),
  or at ``dtype=float64``.  Its streams are keyed by ``env_keys((seed, 0),
  B)``: any two such controllers at one seed see identical scenarios and
  noise.  To pair a therapy with a policy here, pass the therapy as an
  ``(init, fn)`` pair too (e.g. ``controllers.functional.bb_controller``):
  BB on the eager path is the BB that K1a runs, on the eager path's
  streams.

A kernel evaluation and an eager one at the same seed are not paired.

With a ``mesh`` (:mod:`simglucose_tpu_torch.parallel`) the kernel
evaluations split the padded cohort over its ranks (the JAX
``evaluate_policy_kernel``'s ``shard=True``; ``mesh=None`` is its
``shard=False``) and gather the planes; every rank must pass the same arguments (checked by a
digest).  The streams are keyed by global lane, so the result is the
single process's bit for bit.  The eager path runs the whole cohort on
every rank.  Without a mesh nothing is shared.  Evaluation shards patients
over ``'dp'`` alone: a mesh with ``tp > 1`` raises ValueError.  Not here:
the TPU's ``interpret`` and ``t_chunk`` knobs.

Spans (:mod:`simglucose_tpu_torch.utils.profiling`): ``evaluate`` around
each evaluation, ``evaluate.results`` around the copy of its planes to the
host and the statistics computed there (:func:`_results`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis.risk import risk_index
from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.core.types import CtrlAction
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.parallel.sharding import resolve_mesh
from simglucose_tpu_torch.rl.policy import featurize_parts, iob_step, policy_apply
from simglucose_tpu_torch.sim import engine
from simglucose_tpu_torch.utils.profiling import span

PUMP = "Insulet"  # the pump of both evaluations (JAX config_for_sensor's default row)


def policy_controller(params, basal, action_scale: float = None, scale_by_basal: bool = None,
                      sample_time: int = 3, quest=None, bb_target: float = 140.0):
    """A trained policy as a functional controller: its MEAN action through
    the decoder the params were trained with, no sampling, the JAX
    ``policy_controller``.  'sigmoid': rate = sigmoid(mu) * action_scale
    [* basal]; 'residual_bb': rate = bb_cmd * exp(action_scale *
    tanh(mu)), bb_cmd the basal-bolus command from ``basal`` and the
    REQUIRED ``quest=`` CR/CF (a ValueError without it), correcting above
    150 mg/dL towards ``bb_target``.

    ``basal`` ``[B]``: each patient's basal rate (U/min, ``u2ss*BW/6000``).
    Returns the ``(init, fn, in_axes)`` triple of :func:`evaluate_controller`
    and ``simulate()`` (in_axes 0: a state per patient); ``fn`` is
    batch-native over the ``[B]`` leaves of a result.  The state carries
    the previous CGM (-1 before the first call: zero trend) and the
    insulin-on-board, updated each call from the delivered dose
    ``result.insulin``, as the rollout kernel's 'nn' controller does.
    ``action_scale``/``scale_by_basal`` default to the params' own.
    ``sample_time`` must be the env's."""
    if action_scale is None:
        action_scale = float(params.action_scale)
    if scale_by_basal is None:
        scale_by_basal = bool(params.scale_by_basal)
    b = torch.as_tensor(basal)
    if params.decoder == "residual_bb":
        if quest is None:
            raise ValueError("decoder='residual_bb' params need quest= (per-patient CR/CF "
                             "arrays, e.g. load_quest_params(names))")
        cr, cf = torch.as_tensor(quest.CR), torch.as_tensor(quest.CF)
    else:
        cr = cf = torch.zeros_like(b)  # unused carries

    def policy(state, result):
        b_u, cr_u, cf_u, cgm_prev, iob = state
        cgm = result.observation.CGM
        prev = torch.where(cgm_prev < 0, cgm, cgm_prev)
        iob = iob_step(iob, result.insulin, sample_time)
        mu, _, _ = policy_apply(params, featurize_parts(cgm, result.insulin, result.CHO, prev,
                                                        iob, b_u))
        if params.decoder == "residual_bb":
            meal = result.CHO
            bolus_u = (meal * sample_time) / cr_u + (cgm > 150.0).to(mu.dtype) * (
                cgm - bb_target) / cf_u
            bolus = torch.where(meal > 0, bolus_u / sample_time, 0.0)
            rate = (b_u + bolus) * torch.exp(action_scale * torch.tanh(mu))
        else:
            rate = torch.sigmoid(mu) * action_scale
            if scale_by_basal:
                rate = rate * b_u
        return (b_u, cr_u, cf_u, cgm, iob), CtrlAction(basal=rate, bolus=torch.zeros_like(rate))

    return (b, cr, cf, -torch.ones_like(b), torch.zeros_like(b)), policy, 0


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


@span("evaluate.results")
def _results(planes: torch.Tensor, names: list) -> dict:
    """The evaluation's dict from the ``[4, T, B]`` BG/CGM/CHO/insulin
    planes, which reach the host by ``sim/engine.py::_fetch``."""
    bg, cgm, _, insulin = (np.ascontiguousarray(p.T) for p in engine._fetch(planes).numpy())
    out = cohort_stats(bg)
    out["names"] = names
    out["BG"] = bg
    out["CGM"] = cgm
    out["insulin_mean"] = insulin.mean(axis=-1)
    return out


@span("evaluate")
def evaluate_controller(
    controller,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    dtype=np.float32,
    device="cuda",
    mesh=None,
) -> dict:
    """Closed-loop cohort evaluation of one controller: ``'BB'``, ``'PID'``
    or ``('PID', {...})`` (gains ``P``, ``I``, ``D``, ``target``; BB takes
    ``target``) on the rollout kernel K1a, or an ``(init, fn)`` pair /
    ``(init, fn, in_axes)`` triple (such as :func:`policy_controller`'s), or
    any controller at ``dtype=float64``, on the eager env path over the same
    horizon (``envs/rollout.py::rollout_batch``).  See the module docstring
    for which evaluations are paired at one ``seed``.

    Returns :func:`cohort_stats` plus ``names``, the ``BG``/``CGM`` traces
    ``[B, T]`` and the per-patient mean insulin ``insulin_mean``.  On the
    kernel, a ``mesh`` splits the cohort over its ranks (see the module
    docstring)."""
    on_kernel = engine.check_eligible(controller, dtype=dtype)
    device = check_device(device)
    n_steps = _n_steps(hours, sensor)
    mesh = resolve_mesh(mesh)
    names = [patient_names] if isinstance(patient_names, str) else list(patient_names)
    if not on_kernel:
        return _evaluate_eager(controller, names, n_steps, seed, sensor, start_min,
                               random_init_bg, dtype, device)
    cfg = controller_config(controller, sensor, n_steps, start_min, random_init_bg)
    (planes, _), = engine.kernel_cohort("evaluate_controller", cfg, names, seed, device, mesh,
                                        per_call=n_steps)
    return _results(planes, names)


def _evaluate_eager(controller, names, n_steps, seed, sensor, start_min, random_init_bg, dtype,
                    device) -> dict:
    """:func:`evaluate_controller` on the eager env path: the JAX
    function's ``make_env(batch=True)`` + ``rollout_batch``, keyed by
    ``env_keys((seed, 0), B)``."""
    from simglucose_tpu_torch.envs.build import make_env, torch_dtype
    from simglucose_tpu_torch.envs.rollout import rollout_batch
    from simglucose_tpu_torch.ops.streams import env_keys

    dt = torch_dtype(dtype)
    cfg, env_params = make_env(names, sensor=sensor, pump=PUMP, dtype=dt, batch=True,
                               random_init_bg=random_init_bg, device=device)
    init, fn, axes = engine._resolve_controller(controller, cfg, env_params, names, dt, device)
    _, _, traj = rollout_batch(cfg, env_params, env_keys((seed, 0), len(names), device=device),
                               init, fn, n_steps, start_min=start_min, ctrl_in_axes=axes)
    planes = torch.stack([traj.BG, traj.observation.CGM, traj.CHO, traj.insulin])  # [4, B, T]
    return _results(planes.transpose(1, 2), names)


@span("evaluate")
def evaluate_policy_kernel(
    params,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    device="cuda",
    mesh=None,
) -> dict:
    """Closed-loop cohort evaluation of a trained policy on the rollout
    kernel K1b: the policy's mean action (no exploration noise) through the
    decoder its params carry (``decoder``, ``action_scale``,
    ``scale_by_basal``), the environment stochastic.  The trunk must be
    relu (``pack_policy_weights`` raises otherwise).

    Returns the dict of :func:`evaluate_controller`, paired with it at the
    same ``seed``.  A ``mesh`` splits the cohort over its ranks (JAX's
    ``shard=True``: over every device); on one rank it changes nothing."""
    device = check_device(device)
    mesh = resolve_mesh(mesh)
    names = [patient_names] if isinstance(patient_names, str) else list(patient_names)
    cfg = policy_config(params, sensor, _n_steps(hours, sensor), start_min, random_init_bg)
    (planes, _), = engine.kernel_cohort("evaluate_policy_kernel", cfg, names, seed, device, mesh,
                                        weights=tr.pack_policy_weights(params).to(device),
                                        per_call=cfg.n_steps)
    return _results(planes, names)


def stats_frame(results: dict):
    """Per-patient stats dict -> pandas DataFrame, one row per patient (the
    reference's performance_stats.csv shape; pandas is imported here
    only)."""
    import pandas as pd

    cols = {k: v for k, v in results.items() if isinstance(v, np.ndarray) and v.ndim == 1}
    return pd.DataFrame(cols, index=results["names"])
