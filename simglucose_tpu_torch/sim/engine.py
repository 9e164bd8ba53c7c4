"""Cohort simulation engine of the port: ``simulate()`` on two engines.

Counterpart of ``simglucose_tpu/sim/engine.py`` (``_resolve_controller``
:54-89, ``_pallas_eligible`` :106-153, ``_pallas_cfg`` :193-267,
``_simulate_pallas`` :487-644, ``simulate`` :647-920), split in two so the
core runs where pandas is not installed:

* :func:`simulate_cohort` runs the rollout and returns numpy planes: the
  reset row, the ``[T, B]`` BG/CGM/CHO/insulin/LBGI/HBGI/Risk planes and the
  reward plane.
* :func:`simulate` adds the reference-style results DataFrame,
  ``df.attrs['reward']`` and the ``save_path`` CSVs and report.
* :class:`SimObj`, :func:`sim` and :func:`batch_sim` (JAX ``:982-1086``),
  the reference's object API: a batch runs as one ``simulate_cohort``
  call per group of instances that share everything but the patient.

The two engines, as in the JAX package:

* the rollout kernel K1a (``engine='pallas'``; the JAX package's Pallas
  kernel): BB or PID (with their kwargs), random or custom meals, float32,
  rk4 at one substep, any window-based ``reward_fun`` (replayed from the
  CGM planes);
* the eager env path (``engine='xla'``; the JAX package's ``jit(vmap(scan))``
  engine, here a time loop of batch-native env steps,
  :mod:`simglucose_tpu_torch.envs`): any controller, including an
  ``(init, fn)`` pair or an ``(init, fn, in_axes)`` triple, float64,
  any substeps, and ``compat_mode``.

``engine='auto'`` takes the kernel whenever the config is eligible and the
eager path otherwise.  The JAX package's 'auto' also weighs a cold TPU
compile over a remote runtime against the run's size; the port's kernel
build is cached, so 'auto' has no such rule.  Both engines run on
``device`` (default ``"cuda"``, which raises where CUDA is absent;
``"cpu"`` runs the kernel's plain PyTorch version or the eager path on the
CPU).  ``animate=True`` runs the same engine in one-hour calls and
redraws the first four patients' live plots
(:class:`~simglucose_tpu_torch.analysis.rendering.Viewer`, needs pandas and
matplotlib) after each call; the results are the unanimated run's.

With a ``mesh`` (:func:`simglucose_tpu_torch.parallel.sharding.make_mesh`
over a ``torch.distributed`` group, one rank per device) the kernel engine
splits the padded cohort over the ranks, as the JAX engine splits it over
every device, and every rank returns the whole result; every rank must
pass the same arguments (checked by a digest).  The eager engine runs the
whole cohort on every rank.  Without a mesh nothing is shared.  Simulation
shards patients over ``'dp'`` alone: a mesh with ``tp > 1`` raises
ValueError.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from datetime import datetime, timedelta
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis.risk import risk_diff_reward, risk_scalar
from simglucose_tpu_torch.controllers.functional import bb_params, bb_policy, pid_controller
from simglucose_tpu_torch.core.device import check_device, to_host
from simglucose_tpu_torch.envs.build import make_env, torch_dtype
from simglucose_tpu_torch.envs.functional import (
    env_reset,
    replay_rewards,
    reward_history,
    reward_window_size,
    wrap_reward_fn,
)
from simglucose_tpu_torch.envs.rollout import broadcast_ctrl_state, make_batch_continue_fn
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops.rollout import (
    LANES,
    config_for_sensor,
    pack_params,
    rollout,
)
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.parallel.sharding import check_same, gather_lanes, resolve_mesh
from simglucose_tpu_torch.scenario.meal import MealSpec, parse_meal_times
from simglucose_tpu_torch.utils.profiling import count, span

logger = logging.getLogger(__name__)

# Longest horizon (env steps) of one kernel call.  Longer horizons run as
# calls of this many steps that thread the persistent state, so device
# memory is bounded by one call's trajectory; the counter-based generator
# makes the chunked run equal the single call.
MAX_STEPS_PER_CALL = 4096

# controller kwargs each built-in controller accepts (JAX engine :140-141)
_KNOWN_KW = {"BB": {"target"}, "BASAL-BOLUS": {"target"}, "PID": {"P", "I", "D", "target"}}


class FrameFields(NamedTuple):
    """The fields ``trajectory_frame``/``cohort_frame`` read."""

    BG: np.ndarray
    CGM: np.ndarray
    CHO: np.ndarray
    insulin: np.ndarray
    LBGI: np.ndarray
    HBGI: np.ndarray
    risk: np.ndarray


class CohortResult(NamedTuple):
    """Numpy planes of one cohort simulation."""

    reset: FrameFields  # [B] each: the reset row
    traj: FrameFields  # [T, B] each
    reward: np.ndarray  # [T, B]
    sample_time: int


def _controller_spec(controller):
    """Normalize a controller spec to (name_or_None_or_object, kwargs)."""
    if isinstance(controller, dict) and len(controller) == 1:
        (name, kwargs), = controller.items()
        return name, dict(kwargs)
    if (
        isinstance(controller, tuple)
        and len(controller) == 2
        and isinstance(controller[0], str)
        and isinstance(controller[1], dict)
    ):
        return controller[0], dict(controller[1])
    return controller, {}


def kernel_blocker(controller, scenario=None, substeps: int = 1, dtype=np.float32) -> Optional[str]:
    """None if the rollout kernel runs this config, else the reason it
    cannot (JAX ``_pallas_eligible``): BB or PID with only their own
    kwargs, random or custom meals, float32, one substep."""
    if scenario is not None and not (isinstance(scenario, str) and scenario == "random"):
        try:
            parse_meal_times(scenario, datetime(2018, 1, 1))
        except (TypeError, ValueError):
            return "an unparseable custom scenario"
    if substeps != 1:
        return f"substeps={substeps} (the kernel is rk4, 1 substep)"
    if torch_dtype(dtype) != torch.float32:
        return f"dtype={dtype} (the kernel is float32)"
    name, kwargs = _controller_spec(controller)
    if name is None:
        return None
    if not (isinstance(name, str) and name.upper() in _KNOWN_KW
            and set(kwargs) <= _KNOWN_KW[name.upper()]):
        return "a custom controller"
    return None


def check_eligible(controller, *, substeps: int = 1, dtype=np.float32) -> bool:
    """Which engine an evaluation entry point runs ``controller`` on: True
    for the rollout kernel (``'BB'``, ``'PID'``, optionally with their
    kwargs, or None (BB), at float32), False for the eager env path (an
    ``(init, fn)`` pair or ``(init, fn, in_axes)`` triple, or float64).  An
    unknown controller name or kwarg is a ValueError.  Evaluation steps the
    model at one substep per minute on both engines: other ``substeps``
    raise NotImplementedError."""
    name, kwargs = _controller_spec(controller)
    if isinstance(name, str):
        if name.upper() not in _KNOWN_KW:
            raise ValueError(f"controller must be 'BB' or 'PID' (optionally with kwargs); got {name!r}")
        extra = set(kwargs) - _KNOWN_KW[name.upper()]
        if extra:
            raise ValueError(f"controller {name!r} takes no arguments {sorted(extra)}")
    if substeps != 1:
        raise NotImplementedError(
            f"substeps={substeps}: evaluation runs the model at one substep per minute")
    return kernel_blocker(controller, dtype=dtype) is None


def _resolve_controller(controller, cfg, env_params, patient_names, dtype, device):
    """(ctrl_init, ctrl_fn, ctrl_in_axes) of the eager path: 'BB'/'PID'
    (optionally with kwargs), an (init, fn) pair (a shared state) or an
    (init, fn, in_axes) triple (in_axes 0: the state is per patient)."""
    name, kwargs = _controller_spec(controller)
    if name is None or (isinstance(name, str) and name.upper() in ("BB", "BASAL-BOLUS")):
        quest = tables.load_quest_params(patient_names, dtype=dtype, device=device)
        return bb_params(env_params.patient, quest), bb_policy(cfg.sample_time, **kwargs), 0
    if isinstance(name, str) and name.upper() == "PID":
        gains = dict(P=-1e-4, I=-1e-7, D=0.0)
        gains.update(kwargs)
        init, fn = pid_controller(cfg.sample_time, dtype=dtype, device=device, **gains)
        return init, fn, None
    if isinstance(controller, tuple) and len(controller) == 2:
        init, fn = controller
        return init, fn, None
    if isinstance(controller, tuple) and len(controller) == 3:
        return controller
    raise ValueError(
        f"controller must be 'BB', 'PID' (optionally ('PID', kwargs) / "
        f"{{'PID': kwargs}}), an (init, policy) pair, or an "
        f"(init, policy, in_axes) triple; got {controller!r}"
    )


def _call_steps(n_steps: int, per: int = None):
    """Steps of each call: ``per`` (default MAX_STEPS_PER_CALL) each, the
    last call the remainder (the kernel takes its length at run time, so a
    shorter last call costs no rebuild)."""
    m = per or MAX_STEPS_PER_CALL
    return [min(m, n_steps - s) for s in range(0, n_steps, m)]


class _LiveView:
    """The live plots of ``simulate(animate=True)`` (JAX
    ``_simulate_animated``, ``sim/engine.py:921-975``): one Viewer for each
    of the first four patients, redrawn from the steps so far after every
    one-hour call of the engine."""

    def __init__(self, patient_names, start_time, sample_time: int):
        from simglucose_tpu_torch.analysis.rendering import Viewer

        self.names = list(patient_names[:4])
        self.start_time, self.sample_time = start_time, sample_time
        self.viewers = [Viewer(start_time, n) for n in self.names]

    def __call__(self, reset: FrameFields, traj: FrameFields):
        """Redraw from numpy fields: ``reset`` ``[B]`` and ``traj`` ``[t, B]``."""
        from simglucose_tpu_torch.analysis.report import cohort_frame

        k = len(self.names)
        df = cohort_frame(FrameFields(*(a[:k] for a in reset)),
                          FrameFields(*(a[:, :k] for a in traj)), self.names,
                          self.start_time, self.sample_time)
        for v in self.viewers:
            v.render(df.loc[v.patient_name])

    def close(self):
        for v in self.viewers:
            v.close()


def kernel_config(cgm_name: str, insulin_pump_name: str, controller, n_steps: int,
                  start_min: int = 0, random_init_bg: bool = False, *,
                  start_time: Optional[datetime] = None, scenario=None):
    """The rollout configuration of a closed-loop BB / PID run over
    ``n_steps`` steps: the sensor's and the pump's rows, a fixed horizon
    (no auto-reset) from minute ``start_min`` of the day, random meals or
    the custom ``scenario`` (a list of (time, grams), times read from
    ``start_time``)."""
    pump = tables.pump_record(insulin_pump_name)
    name, kwargs = _controller_spec(controller)
    fields = {}
    if isinstance(name, str) and name.upper() == "PID":
        gains = dict(P=-1e-4, I=-1e-7, D=0.0, target=140.0)
        gains.update(kwargs)
        fields = dict(
            controller="pid", pid_p=float(gains["P"]), pid_i=float(gains["I"]),
            pid_d=float(gains["D"]), pid_target=float(gains["target"]),
        )
    else:
        fields = dict(controller="bb")
        if "target" in kwargs:
            fields["bb_target"] = float(kwargs["target"])
    if scenario is not None and not isinstance(scenario, str):
        # a CustomScenario is the kernel's static schedule in episode minutes
        t_arr, a_arr = parse_meal_times(scenario, start_time)
        fields.update(
            scenario_kind="static",
            det_meal_times=tuple(int(t) for t in t_arr),
            det_meal_amounts=tuple(float(a) for a in a_arr),
        )
    elif scenario not in (None, "random"):
        raise ValueError(f"scenario must be None, 'random' or a list of (time, grams); got {scenario!r}")
    cfg = config_for_sensor(
        cgm_name,
        n_steps=n_steps,
        inc_basal=float(pump["inc_basal"]),
        min_basal=float(pump["min_basal"]),
        max_basal=float(pump["max_basal"]),
        inc_bolus=float(pump["inc_bolus"]),
        min_bolus=float(pump["min_bolus"]),
        max_bolus=float(pump["max_bolus"]),
        random_init_bg=random_init_bg,
        autoreset=False,
        fixed_start_min=start_min,
        **fields,
    )
    return cfg


def _finish(planes, reward_fun, window_size, history):
    """``[4, T, B]`` BG/CGM/CHO/insulin -> ``[8, T, B]`` with the
    LBGI/HBGI/risk planes of BG and the reward replayed from CGM, on the
    planes' device; and the reward history after the last step."""
    rewards, history = replay_rewards(reward_fun, window_size, history, planes[1])
    return torch.cat([planes, torch.stack([*risk_scalar(planes[0]), rewards])]), history


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host (:func:`~simglucose_tpu_torch.core.device.to_host`:
    from the card, one DMA into page-locked memory, which goes back to
    PyTorch's host cache once the caller drops it), under the span
    ``cohort.fetch``, which counts its ``bytes`` and the ``pinned_bytes``
    of them that went to page-locked memory."""
    with span("cohort.fetch"):
        host = to_host(t)
        n = t.numel() * t.element_size()
        count("bytes", n)
        count("pinned_bytes", n if t.is_cuda else 0)
        return host


def _assemble(pieces: list) -> torch.Tensor:
    """The calls' ``[k, t, B]`` pieces on the host as one ``[k, T, B]``
    tensor: a single piece is itself (from the card, the page-locked
    tensor it was fetched into, with no second copy), several are
    concatenated along time."""
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


@span("simulate_cohort")
def simulate_cohort(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    animate: bool = False,
    parallel: bool = True,  # accepted for API familiarity; always one batch
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    device="cuda",
    mesh=None,
) -> CohortResult:
    """Closed-loop cohort simulation -> numpy planes.

    Arguments are :func:`simulate`'s.  Fixed horizon, no auto-reset (the
    reference batch_sim semantics).  The random streams are keyed by the
    pair (scenario_seed, cgm_seed), each 0 when omitted.

    ``engine``: 'pallas' runs the rollout kernel and raises ``ValueError``
    for a config it cannot run; 'xla' runs the eager env path; 'auto'
    takes the kernel whenever it can.  On the kernel the rewards are
    replayed from the CGM planes with the env's window law, so any
    window-based ``reward_fun`` applies; the eager path computes them in
    the step, where an ``(init, fn)`` controller may read them.

    ``compat_mode=True`` is the reference-verification configuration:
    float64, rk45 at 4 substeps per minute, and the reference's MT19937 CGM
    noise and meal scenario shared by the cohort, as the reference's
    simulate() gives every patient the same cgm_seed sensor and a copy of
    the same scenario.  It needs ``cgm_seed`` (and ``scenario_seed`` for
    random meals) and runs the eager path.

    ``mesh`` splits the kernel engine's cohort over its ranks (see the
    module docstring); None runs it on this process alone."""
    del parallel
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError(f"engine must be 'auto', 'xla', or 'pallas'; got {engine!r}")
    if compat_mode:
        if engine == "pallas":
            raise ValueError("compat_mode requires the XLA engine")
        engine, dtype, substeps, random_init_bg = "xla", np.float64, 4, False
        if cgm_seed is None:
            raise ValueError("compat_mode requires an explicit cgm_seed")
        if scenario_seed is None and (scenario is None or isinstance(scenario, str)):
            raise ValueError("compat_mode with a random scenario requires scenario_seed")
    blocker = kernel_blocker(controller, scenario, substeps, dtype)
    if engine == "pallas" and blocker is not None:
        raise ValueError(
            f"engine='pallas' cannot run this config ({blocker}); use engine='xla' or 'auto'"
        )
    device = check_device(device)
    if patient_names is None:
        patient_names = tables.patient_names()
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    if start_time is None:
        start_time = datetime(2018, 1, 1, 0, 0, 0)
    st = tables.sensor_sample_time(cgm_name)
    n_steps = int(sim_time.total_seconds() // 60) // st
    if n_steps < 1:
        raise ValueError(f"sim_time {sim_time} is shorter than one {st}-min sample")
    mesh = resolve_mesh(mesh)
    # only rank 0 draws (every rank holds the whole result)
    live = _LiveView(patient_names, start_time, st) if animate and mesh.rank == 0 else None
    run = dict(patient_names=patient_names, cgm_name=cgm_name, insulin_pump_name=insulin_pump_name,
               controller=controller, n_steps=n_steps, start_time=start_time, scenario=scenario,
               scenario_seed=scenario_seed, cgm_seed=cgm_seed, random_init_bg=random_init_bg,
               reward_fun=reward_fun, device=device,
               per_call=max(60 // st, 1) if animate else None, on_call=live)
    tic = time.perf_counter()
    try:
        if engine != "xla" and blocker is None:
            res, which = _simulate_kernel(**run, mesh=mesh), "rollout kernel"
        else:
            res = _simulate_eager(dtype=torch_dtype(dtype), substeps=substeps,
                                  compat_mode=compat_mode, **run)
            which = "eager env path"
    finally:
        if live is not None:
            live.close()
    logger.info(
        "Simulation of %d patients x %s took %.3f s (%s, %s)",
        len(patient_names), sim_time, time.perf_counter() - tic, which, device,
    )
    return res


def _reset_fields(reset: np.ndarray) -> FrameFields:
    """The kernel engine's reset rows ``[5, B]`` (BG, CGM, LBGI, HBGI,
    risk) as FrameFields, CHO and insulin 0."""
    zeros = np.zeros(reset.shape[1], np.float32)
    return FrameFields(reset[0], reset[1], zeros, zeros, *reset[2:])


def kernel_cohort(what: str, cfg, patient_names: list, key, device, mesh, *, weights=None,
                  per_call: Optional[int] = None, same: tuple = ()):
    """The cohort on the rollout kernel (K1a; K1b with the ``'nn'``
    controller's ``weights``), its lanes split over the ranks of ``mesh``,
    for :func:`simulate_cohort` and the kernel evaluations.  The names are
    padded by cycling them to 128 x ``mesh.dp`` lanes (the real patients
    keep lanes 0..B-1); each rank packs the tables of its own lanes, and
    its streams are keyed by global lane, so the result is the single
    process's bit for bit.  Every rank must pass the same arguments and
    ``same`` (what else its result depends on): one digest, named
    ``what``, checks them.  Yields, per call of ``per_call`` steps at most
    (default ``MAX_STEPS_PER_CALL``), ``(planes, reset)``: the ``[4, t,
    B]`` BG/CGM/CHO/insulin planes gathered on every rank, and at the first
    call the ``[2, B]`` BG0/CGM0 reset row (None after)."""
    B = len(patient_names)
    with span("cohort.prepare"):
        check_same(mesh, what, (cfg, patient_names, key, weights, per_call, *same))
        unit = LANES * mesh.dp
        per = -(-B // unit) * unit // mesh.dp
        lane0 = mesh.dp_rank * per
        names = [patient_names[i % B] for i in range(lane0, lane0 + per)]  # this rank's lanes
        patient = tables.load_patient_params(names, device=device)
        quest = tables.load_quest_params(names, device=device)
        packed = pack_params(patient, basal_rate(patient), quest=quest)
    state, offset = None, 0
    for steps in _call_steps(cfg.n_steps, per_call):
        traj = rollout(
            dataclasses.replace(cfg, n_steps=steps), packed, key, state=state,
            init=int(offset == 0), step_offset=offset, weights=weights, lane_offset=lane0,
        )
        state = (traj["state_f"], traj["state_i"])
        planes = torch.stack([traj[k] for k in ("BG", "CGM", "CHO", "insulin")])
        planes = gather_lanes(planes, mesh)[..., :B].contiguous()
        reset = None
        if offset == 0:
            reset = gather_lanes(torch.stack([traj["BG0"], traj["CGM0"]]), mesh)[:, :B]
        yield planes, reset
        offset += steps


def _simulate_kernel(patient_names, cgm_name, insulin_pump_name, controller, n_steps, start_time,
                     scenario, scenario_seed, cgm_seed, random_init_bg, reward_fun, device, mesh,
                     per_call=None, on_call=None):
    """The cohort on the rollout kernel K1a (:func:`kernel_cohort`); every
    rank returns the whole result.  ``per_call`` caps the steps of a call,
    and ``on_call(reset, traj)`` gets the numpy fields of the steps so far
    after each call (the live plots).

    Where the horizon takes one call on the card (up to
    ``MAX_STEPS_PER_CALL`` steps), the result's planes are numpy views of
    the one page-locked host tensor the call's planes were copied into;
    its block goes back to PyTorch's host cache once the caller drops the
    result, for the next call to reuse.  Several calls' pieces are
    concatenated into pageable memory."""
    st = tables.sensor_sample_time(cgm_name)
    start_min = (start_time.hour * 60 + start_time.minute) % 1440
    cfg = kernel_config(
        cgm_name, insulin_pump_name, controller, n_steps, start_min, random_init_bg,
        start_time=start_time, scenario=scenario,
    )
    key = (scenario_seed or 0, cgm_seed or 0)
    W = reward_window_size(st)

    # Each call's BG/CGM/CHO/insulin planes are finished (risk planes and
    # rewards appended) on the device and go to the host in one DMA, so
    # device memory holds one call's trajectory however long the horizon;
    # the reward window's history carries from call to call.  On the CPU,
    # torch rounds log/pow differently in its vectorised loop and in the
    # scalar tail, so the same BG would take other ulps in other call
    # shapes: there the planes are finished once over the whole horizon,
    # and a chunked run stays bit-equal to one call.
    finish_per_call = device.type == "cuda"
    host = []
    for planes, bg_cgm0 in kernel_cohort("simulate_cohort", cfg, patient_names, key, device, mesh,
                                         per_call=per_call, same=(reward_fun,)):
        if bg_cgm0 is not None:
            bg0, cgm0 = bg_cgm0
            with span("cohort.finish"):
                reset = torch.stack([bg0, cgm0, *risk_scalar(bg0)])
                history = reward_history(W, cgm0)
            reset = _fetch(reset)
        if finish_per_call:
            with span("cohort.finish"):
                planes, history = _finish(planes, reward_fun, W, history)
        host.append(_fetch(planes))
        if on_call is not None:
            so_far = _assemble(host)
            if not finish_per_call:  # the risk planes to draw
                so_far = torch.cat([so_far, torch.stack(risk_scalar(so_far[0]))])
            on_call(_reset_fields(reset.numpy()), FrameFields(*so_far[:7].numpy()))
    out = _assemble(host)
    if not finish_per_call:
        with span("cohort.finish"):
            out, _ = _finish(out, reward_fun, W, history)
    out = out.numpy()
    return CohortResult(
        reset=_reset_fields(reset.numpy()),
        traj=FrameFields(*out[:7]),
        reward=out[7],
        sample_time=st,
    )


def _simulate_eager(patient_names, cgm_name, insulin_pump_name, controller, n_steps, start_time,
                    scenario, scenario_seed, cgm_seed, random_init_bg, reward_fun, device, dtype,
                    substeps, compat_mode, per_call=None, on_call=None):
    """The cohort on the eager env path (JAX ``simulate``'s general branch,
    :819-900): every patient an env of one batch, stepped ``n_steps`` times
    on ``device``; the planes go to the host in one copy at the end.
    ``per_call`` and ``on_call`` are :func:`_simulate_kernel`'s: the steps
    run in calls of ``per_call`` that continue the episodes (JAX
    ``make_batch_continue_fn``), each followed by a copy for ``on_call``."""
    B = len(patient_names)
    st = tables.sensor_sample_time(cgm_name)
    custom_times = custom_amounts = None
    scenario_mode = "random"
    if scenario is not None and not isinstance(scenario, str):
        t_arr, a_arr = parse_meal_times(scenario, start_time)
        custom_times = torch.as_tensor(t_arr, dtype=torch.int32, device=device).expand(B, -1)
        custom_amounts = torch.as_tensor(a_arr, dtype=dtype, device=device).expand(B, -1)
        scenario_mode = "custom"
    elif scenario not in (None, "random"):
        raise ValueError(f"scenario must be None, 'random' or a list of (time, grams); got {scenario!r}")
    noise_seq = meal_seq = None
    method = "rk4"
    if compat_mode:
        # the reference's MT19937 streams, shared by the cohort
        from simglucose_tpu_torch.compat.noise import reference_cgm_noise
        from simglucose_tpu_torch.compat.scenario import reference_meal_seq

        method = "rk45"
        n_min = n_steps * st
        noise_seq = reference_cgm_noise(tables.sensor_record(cgm_name), int(cgm_seed), n_steps + 4)
        if scenario_mode == "random":
            meal_seq = reference_meal_seq(int(scenario_seed), start_time, n_min + st)
            scenario_mode = "exogenous"
    cfg, env_params = make_env(
        patient_names, sensor=cgm_name, pump=insulin_pump_name, dtype=dtype, batch=True,
        substeps=substeps, method=method, noise_seq=noise_seq, meal_seq=meal_seq,
        scenario_mode=scenario_mode, random_init_bg=random_init_bg, device=device,
    )
    if custom_times is not None:
        env_params = env_params._replace(custom_times=custom_times, custom_amounts=custom_amounts)
    ctrl_state, ctrl_fn, ctrl_axes = _resolve_controller(
        controller, cfg, env_params, patient_names, dtype, device
    )
    if ctrl_axes is None:
        ctrl_state = broadcast_ctrl_state(ctrl_state, B)
    reward_fun = wrap_reward_fn(reward_fun, cfg.window_size)
    start_min = (start_time.hour * 60 + start_time.minute) % 1440
    keys = env_keys((scenario_seed or 0, cgm_seed or 0), B, device=device)

    planes = lambda r: torch.stack([getattr(r, f) for f in FrameFields._fields + ("reward",)])
    state, last = env_reset(cfg, env_params, keys, start_min=start_min)
    reset = planes(last).cpu().numpy()
    pieces = []
    for steps in _call_steps(n_steps, per_call or n_steps):
        run = make_batch_continue_fn(cfg, ctrl_fn, steps, reward_fun=reward_fun)
        state, ctrl_state, last, traj = run(env_params, state, ctrl_state, last)
        pieces.append(planes(traj))
        if on_call is not None:
            so_far = torch.cat(pieces, dim=1).cpu().numpy()
            on_call(FrameFields(*reset[:7]), FrameFields(*so_far[:7]))
    out = torch.cat(pieces, dim=1).cpu().numpy()  # [8, T, B], one copy to the host
    return CohortResult(reset=FrameFields(*reset[:7]), traj=FrameFields(*out[:7]), reward=out[7],
                        sample_time=st)


@span("simulate")
def simulate(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    save_path: Optional[str] = None,
    animate: bool = False,
    parallel: bool = True,
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    device="cuda",
    mesh=None,
):
    """Run a closed-loop cohort simulation and return the results frame.

    The JAX package's ``simulate`` (reference simulation/user_interface.py:
    303-385) on the port's engines (:func:`simulate_cohort`): ``scenario``
    None or 'random' draws per-patient random daily meal plans, a list of
    (time, grams) is a custom scenario for every patient; ``controller`` is
    'BB' (default) or 'PID', optionally with kwargs (``('PID', dict(P=...,
    I=..., D=..., target=...))``), an ``(init, fn)`` pair or an ``(init,
    fn, in_axes)`` triple.  A custom ``fn(state, result)`` is batch-native:
    ``result``'s leaves are ``[B]`` tensors, one per patient (the JAX
    package calls it per patient under vmap).  Returns the (patient, Time)
    multi-indexed frame with
    the per-step rewards ``[T, B]`` in ``df.attrs['reward']``; with
    ``save_path`` also writes per-patient CSVs and the analysis report.
    Needs pandas (and matplotlib for the report).  ``mesh`` is
    :func:`simulate_cohort`'s; every rank returns the whole frame, and only
    its rank 0 writes ``save_path``."""
    from simglucose_tpu_torch.analysis.report import cohort_frame, report

    if patient_names is None:
        patient_names = tables.patient_names()
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    if start_time is None:
        start_time = datetime(2018, 1, 1, 0, 0, 0)
    res = simulate_cohort(
        sim_time=sim_time, scenario=scenario, scenario_seed=scenario_seed,
        controller=controller, patient_names=patient_names, cgm_name=cgm_name,
        cgm_seed=cgm_seed, insulin_pump_name=insulin_pump_name,
        start_time=start_time, animate=animate, parallel=parallel,
        random_init_bg=random_init_bg, dtype=dtype, substeps=substeps,
        reward_fun=reward_fun, engine=engine, compat_mode=compat_mode,
        device=device, mesh=mesh,
    )
    with span("cohort.frame"):
        df = cohort_frame(res.reset, res.traj, patient_names, start_time, res.sample_time)
    df.attrs["reward"] = res.reward
    if save_path is not None and resolve_mesh(mesh).rank == 0:
        os.makedirs(save_path, exist_ok=True)
        for name in patient_names:
            df.loc[name].to_csv(os.path.join(save_path, f"{name}.csv"))
        report(df, save_path=save_path)
    return df


class _Same:
    """A fuse-key entry equal only to another wrapping the very same
    object."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def _by_value(v):
    """``v`` itself where it hashes (equal values fuse), else its identity."""
    try:
        hash(v)
    except TypeError:
        return _Same(v)
    return v


class SimObj:
    """Familiar OO shim over one patient's simulation
    (reference: simulation/sim_engine.py:15-49; JAX ``sim/engine.py:982-1040``).

    ``seed`` is the scenario seed; ``kwargs`` are :func:`simulate_cohort`'s
    (``cgm_seed``, ``engine``, ``compat_mode``, ``dtype``, ``mesh``, ...),
    and the run goes to ``device`` (default ``"cuda"``).  ``animate=True``
    draws the live plots, as ``simulate(animate=True)`` does.  The results are the reference's per-patient frame (needs
    pandas)."""

    def __init__(
        self,
        patient_name: str,
        controller=None,
        sim_time: timedelta = timedelta(days=1),
        start_time: Optional[datetime] = None,
        scenario: Optional[Union[str, MealSpec]] = None,
        seed: int = 0,
        animate: bool = False,
        path: Optional[str] = None,
        device="cuda",
        **kwargs,
    ):
        self.patient_name = patient_name
        self.controller = controller
        self.sim_time = sim_time
        self.start_time = start_time or datetime(2018, 1, 1)
        self.scenario = scenario
        self.seed = seed
        self.animate = animate
        self.path = path
        self.device = device
        self.kwargs = kwargs
        self._results = None

    def _fuse_key(self):
        """Instances with equal keys run as one cohort.  A controller fuses
        by value only as a name (or None): any other controller, an
        ``('PID', {...})`` pair or an ``(init, fn)`` pair, only with the
        very same object.  The JAX package keys every such controller by
        its type name (``tuple``), so a PID and a BB instance fuse there
        and both run the first one's controller."""
        c, s = self.controller, self.scenario
        ctrl = c if c is None or isinstance(c, str) else _Same(c)
        scen = s if s is None or isinstance(s, str) else tuple(map(tuple, s))
        kwargs = tuple(sorted((k, _by_value(v)) for k, v in self.kwargs.items()))
        return (ctrl, self.sim_time, self.start_time, _by_value(scen), self.seed, self.animate,
                torch.device(self.device), kwargs)

    def _cohort_kwargs(self) -> dict:
        return dict(sim_time=self.sim_time, scenario=self.scenario, scenario_seed=self.seed,
                    controller=self.controller, start_time=self.start_time, animate=self.animate,
                    device=self.device, **self.kwargs)

    def _take(self, res: CohortResult, b: int):
        """This instance's frame from column ``b`` of a cohort result."""
        from simglucose_tpu_torch.analysis.report import trajectory_frame

        reset = FrameFields(*(a[b] for a in res.reset))
        traj = FrameFields(*(a[:, b] for a in res.traj))
        self._results = trajectory_frame(reset, traj, self.start_time, res.sample_time)
        return self._results

    def simulate(self):
        (res, _), = _batch_cohorts([self])
        return self._take(res, 0)

    def results(self):
        if self._results is None:
            self.simulate()
        return self._results

    def save_results(self):
        if self.path is None:
            raise ValueError("SimObj.path not set")
        os.makedirs(self.path, exist_ok=True)
        self.results().to_csv(os.path.join(self.path, f"{self.patient_name}.csv"))


def _batch_cohorts(sim_instances: Sequence[SimObj]):
    """Group the instances by their fuse key and run each group as one
    :func:`simulate_cohort` call (one rollout-kernel launch per
    ``MAX_STEPS_PER_CALL`` steps on the kernel engine).  Returns ``[(CohortResult,
    instance indices)]``, column ``b`` of a result belonging to its
    ``b``-th index; needs no pandas."""
    groups = {}
    for i, o in enumerate(sim_instances):
        groups.setdefault(o._fuse_key(), []).append(i)
    out = []
    for idx in groups.values():
        first = sim_instances[idx[0]]
        names = [sim_instances[i].patient_name for i in idx]
        out.append((simulate_cohort(patient_names=names, **first._cohort_kwargs()), idx))
    return out


def sim(sim_object: SimObj):
    """Run one SimObj (reference: sim_engine.py:56-62)."""
    logger.info("Simulating %s", sim_object.patient_name)
    res = sim_object.simulate()
    if sim_object.path is not None:
        sim_object.save_results()
    return res


def batch_sim(sim_instances: Sequence[SimObj], parallel: bool = False):
    """Run a batch of SimObjs (reference: sim_engine.py:65-76).

    Instances that share controller, sim_time, start time, scenario, seed,
    device and kwargs run as ONE cohort (:func:`simulate_cohort` over their
    patients); each other group runs as its own cohort.  A patient's random
    streams are keyed by its position in its cohort, as in the JAX package,
    so a fused instance's CGM noise and meals are not those of its
    :func:`sim` alone.  ``parallel`` is accepted for API familiarity: a
    cohort is always one batch.  Returns the per-patient frames, in order."""
    del parallel
    tic = time.perf_counter()
    for res, idx in _batch_cohorts(sim_instances):
        for b, i in enumerate(idx):
            o = sim_instances[i]
            o._take(res, b)
            if o.path is not None:
                o.save_results()
    logger.info("Simulation took %.3f sec.", time.perf_counter() - tic)
    return [o._results for o in sim_instances]
