"""Gymnasium adapter of the port: the reference's gym API over the eager env.

Counterpart of ``simglucose_tpu/envs/gym_env.py:54-589``.  Semantics of the
reference wrapper (reference: envs/simglucose_gym_env.py:18-85):

* scalar action = basal only, bolus = 0;
* Dexcom CGM + Insulet pump unless overridden;
* every reset builds a brand-new episode: a fresh start hour (0-23 on
  2018-01-01), a fresh scenario and a random initial BG;
* the seed chain seed2/3/4 and the hour come from gym 0.9.4's seeding
  (:mod:`simglucose_tpu_torch.compat.seeding`), so ``seed(0)`` lands on the
  reference's 23:00 start;
* ``action_space = Box[0, pump.max_basal]``, ``observation_space =
  Box[0, inf)``.

Two episode-generation modes, as in the JAX package:

* ``compat_mode=False`` (default): the port's Philox streams, keyed by the
  seed pair (seed3 for the scenario, seed2 for the CGM; seed2 fixes seed3
  and seed4, so the pair loses nothing).  The JAX package mixes the three
  seeds into one 31-bit key (``(seed2 * 1000003 + seed3 * 1009 + seed4) %
  2**31``), which aliases; the port does not.
* ``compat_mode=True``: CGM noise, meals and the initial state made on the
  host with MT19937 (:mod:`simglucose_tpu_torch.compat`), float64, rk45 at
  4 substeps: an episode is the JAX package's, trace for trace.

The single env draws the episode live with ``render_mode='human'`` (the
:class:`~simglucose_tpu_torch.analysis.rendering.Viewer`, as in the JAX
package; the vector env, like the JAX one, has no render mode).  The envs
run on ``device`` (default ``"cuda"``).  gymnasium is optional:
this module never imports it at load time (the card's machine has none).
``T1DSimGymEnv`` and ``T1DSimVectorEnv`` are built at first use, on
``gymnasium.Env`` / ``gymnasium.vector.VectorEnv`` where gymnasium imports
and on ``object`` where it does not; without it they construct, reset and
step, and reading a space raises ImportError.
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis.risk import risk_diff_reward
from simglucose_tpu_torch.compat.noise import reference_cgm_noise
from simglucose_tpu_torch.compat.patient import reference_init_state
from simglucose_tpu_torch.compat.scenario import reference_meal_seq
from simglucose_tpu_torch.compat.seeding import gym_seed_chain, np_random
from simglucose_tpu_torch.core.device import check_device, to_host
from simglucose_tpu_torch.core.types import CtrlAction
from simglucose_tpu_torch.envs.build import make_env, torch_dtype
from simglucose_tpu_torch.envs.functional import env_reset, env_step, wrap_reward_fn
from simglucose_tpu_torch.envs.rollout import autoreset_step, batch_reset
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.scenario.meal import MealSpec, parse_meal_times
from simglucose_tpu_torch.utils.profiling import count, span

__all__ = ["parse_meal_times", "T1DSimGymEnv", "T1DSimVectorEnv", "register_envs"]


def _gymnasium():
    """The gymnasium module, or None where it is not installed."""
    try:
        import gymnasium
    except ImportError:
        return None
    return gymnasium


def _box(high: float, shape: tuple):
    gym = _gymnasium()
    if gym is None:
        raise ImportError("the action and observation spaces are gymnasium.spaces.Box: "
                          "install gymnasium to read them")
    return gym.spaces.Box(low=0.0, high=high, shape=shape, dtype=np.float32)


def _wrap_reward(reward_fun, window_size: int):
    """Native ``(window, window_len)`` reward functions, or reference-style
    1-argument ones over the BG-last-hour history (reference:
    simulation/env.py:100-102), adapted by
    :func:`~simglucose_tpu_torch.envs.functional.wrap_reward_fn`."""
    if reward_fun is None:
        return risk_diff_reward
    return wrap_reward_fn(reward_fun, window_size)


# the scalars of a single-env step, in the order of _GymEnv._host's row
_SCALARS = ("obs", "reward", "done", "CHO", "insulin", "BG", "CGM", "LBGI", "HBGI", "risk", "t")


class _GymEnv:
    """Single-env Gymnasium wrapper (reference: envs/simglucose_gym_env.py).

    A step is one :func:`~simglucose_tpu_torch.envs.functional.env_step` on
    ``device`` and one copy of its numbers to the host, which the Gymnasium
    API hands out as Python and numpy values."""

    metadata = {"render_modes": ["human"]}
    SENSOR_HARDWARE = "Dexcom"
    INSULIN_PUMP_HARDWARE = "Insulet"

    def __init__(
        self,
        patient_name: Optional[str] = None,
        custom_scenario: Optional[MealSpec] = None,
        reward_fun: Optional[Callable] = None,
        seed: Optional[int] = None,
        sensor: Optional[str] = None,
        pump: Optional[str] = None,
        compat_mode: bool = False,
        horizon_days: float = 30,
        substeps: Optional[int] = None,
        dtype=None,
        render_mode: Optional[str] = None,
        device="cuda",
    ):
        if patient_name is None:
            # reference hard-codes this default (simglucose_gym_env.py:33-35)
            patient_name = "adolescent#001"
        self.patient_name = patient_name
        self.sensor_name = sensor or self.SENSOR_HARDWARE
        self.pump_name = pump or self.INSULIN_PUMP_HARDWARE
        self.compat_mode = compat_mode
        # fractional days allowed (e.g. horizon_days=0.5 -> 12 h episodes)
        self.horizon_minutes = int(float(horizon_days) * 1440)
        self.render_mode = render_mode
        self._viewer = None
        self.device = check_device(device)
        self._raw_reward_fun = reward_fun
        self._substeps = substeps if substeps is not None else (4 if compat_mode else 1)
        self._dtype = torch_dtype(dtype if dtype is not None
                                  else (torch.float64 if compat_mode else torch.float32))
        self._np_dtype = torch.empty(0, dtype=self._dtype).numpy().dtype
        self._custom = (
            None if custom_scenario is None
            else parse_meal_times(custom_scenario, datetime(2018, 1, 1))
        )
        self._history = []
        self.np_random_state, self._seed1 = np_random(seed)
        self._build_static()
        self._new_episode()

    # -- construction ------------------------------------------------------

    def _build_static(self):
        """The config and the parameters shared by every episode."""
        st = tables.sensor_sample_time(self.sensor_name)
        noise_seq = meal_seq = None
        if self.compat_mode:
            # placeholders of the episodes' host-made sequences
            scenario_mode = "custom" if self._custom else "exogenous"
            noise_seq = np.zeros(self.horizon_minutes // st + 4)
            if not self._custom:
                meal_seq = np.zeros(self.horizon_minutes + st)
        else:
            scenario_mode = "custom" if self._custom else "random"
        custom_times, custom_amounts = self._custom or (None, None)
        self.cfg, self._params0 = make_env(
            self.patient_name, sensor=self.sensor_name, pump=self.pump_name, dtype=self._dtype,
            substeps=self._substeps, method="rk45" if self.compat_mode else "rk4",
            noise_seq=noise_seq, meal_seq=meal_seq, custom_times=custom_times,
            custom_amounts=custom_amounts, scenario_mode=scenario_mode,
            random_init_bg=not self.compat_mode, device=self.device,
        )
        self._x0 = self._params0.patient.x0.cpu().numpy().astype(np.float64)
        self._reward = _wrap_reward(self._raw_reward_fun, self.cfg.window_size)

    def _new_episode(self):
        """Fresh episode randomness, the analog of the reference's
        brand-new env per reset (simglucose_gym_env.py:48-51)."""
        seed2, seed3, seed4, hour = gym_seed_chain(self.np_random_state)
        self._seeds = (seed2, seed3, seed4)
        self.start_time = datetime(2018, 1, 1, hour, 0, 0)
        key = env_keys((seed3, seed2), 1, device=self.device)[0]
        params = self._params0
        init_state = None
        if self.compat_mode:
            st = self.cfg.sample_time
            as_t = lambda a: torch.as_tensor(a, dtype=self._dtype, device=self.device)
            noise = reference_cgm_noise(tables.sensor_record(self.sensor_name), seed2,
                                        self.horizon_minutes // st + 4)
            params = params._replace(noise_seq=as_t(noise))
            if self._custom is None:
                meals = reference_meal_seq(seed3, self.start_time, self.horizon_minutes + st)
                params = params._replace(meal_seq=as_t(meals))
            init_state = as_t(reference_init_state(self._x0, seed4))
        self._params = params
        self._state, self._last = env_reset(self.cfg, params, key, start_min=hour * 60,
                                            init_state=init_state)

    # -- gymnasium API -----------------------------------------------------

    @property
    def action_space(self):
        return _box(float(tables.pump_record(self.pump_name)["max_basal"]), (1,))

    @property
    def observation_space(self):
        return _box(np.inf, (1,))

    def _host(self, res) -> dict:
        """The step's numbers the Gymnasium API hands out, read in one copy
        from the device: ``_SCALARS`` and the patient's state ``x``."""
        s = self._state
        scalars = torch.stack([v.to(torch.float64) for v in (
            res.observation.CGM, res.reward, res.done, res.CHO, res.insulin, res.BG, res.CGM,
            res.LBGI, res.HBGI, res.risk, s.patient.t)])
        row = to_host(torch.cat([scalars, s.patient.x.to(torch.float64)])).numpy()
        out = dict(zip(_SCALARS, row[:len(_SCALARS)].tolist()))
        out["x"] = row[len(_SCALARS):].astype(self._np_dtype)
        out["time"] = self.start_time + timedelta(minutes=int(out["t"]))
        return out

    @staticmethod
    def _obs(h: dict) -> np.ndarray:
        return np.asarray([h["obs"]], np.float32)

    def _info(self, h: dict) -> dict:
        """The reference's rich info dict (simulation/env.py:106-117)."""
        return {
            "sample_time": self.cfg.sample_time,
            "patient_name": self.patient_name,
            "meal": h["CHO"],
            "patient_state": h["x"],
            "time": h["time"],
            "bg": h["BG"],
            "lbgi": h["LBGI"],
            "hbgi": h["HBGI"],
            "risk": h["risk"],
        }

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self.np_random_state, self._seed1 = np_random(seed)
        self._new_episode()
        self._history = []
        h = self._host(self._last)
        self._record(h)
        return self._obs(h), self._info(h)

    def step(self, action):
        basal = torch.as_tensor(np.asarray(action, dtype=np.float64).reshape(()), dtype=self._dtype,
                                device=self.device)
        act = CtrlAction(basal=basal, bolus=torch.zeros_like(basal))
        self._state, self._last = env_step(self.cfg, self._params, self._state, act,
                                           reward_fun=self._reward)
        h = self._host(self._last)
        self._record(h)
        # horizon_days bounds every episode (in compat mode it also bounds
        # the host-made noise and meal sequences)
        truncated = int(h["t"]) + self.cfg.sample_time > self.horizon_minutes
        return self._obs(h), h["reward"], bool(h["done"]), truncated, self._info(h)

    def seed(self, seed: Optional[int] = None):
        """Legacy gym 0.9.4 seeding contract (simglucose_gym_env.py:53-56):
        re-seeds AND rebuilds the episode; returns [seed1..seed4]."""
        self.np_random_state, seed1 = np_random(seed)
        self._new_episode()
        return [seed1, *self._seeds]

    # -- rendering / history ----------------------------------------------

    def _record(self, h: dict):
        self._history.append({"Time": h["time"], "BG": h["BG"], "CGM": h["CGM"], "CHO": h["CHO"],
                              "insulin": h["insulin"], "LBGI": h["LBGI"], "HBGI": h["HBGI"],
                              "Risk": h["risk"]})

    def show_history(self):
        """Episode history as a DataFrame (reference: env.py:169-180)."""
        import pandas as pd

        df = pd.DataFrame(self._history)
        if len(df):
            df = df.set_index("Time")
        return df

    def render(self):
        """``render_mode='human'``: redraw the episode so far in the live
        Viewer (needs pandas and matplotlib)."""
        if self.render_mode != "human":
            return
        from simglucose_tpu_torch.analysis.rendering import Viewer

        if self._viewer is None:
            self._viewer = Viewer(self.start_time, self.patient_name)
        self._viewer.render(self.show_history())

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None


# the planes of a vector-env step, in the order of _step_planes' rows
_PLANES = ("obs", "reward", "terminated", "truncated", "bg", "risk", "meal", "insulin",
           "final_obs", "final_bg", "final_risk")


def _step_planes(res, carry, trunc) -> torch.Tensor:
    """``[len(_PLANES), B]`` in the env's dtype: what the agent sees next
    (the new episode's reset where one ended), the step's reward and flags,
    and the terminal step's observation, BG and risk."""
    dtype = res.reward.dtype
    return torch.stack([carry.observation.CGM, res.reward, res.done.to(dtype), trunc.to(dtype),
                        carry.BG, carry.risk, carry.CHO, carry.insulin, res.observation.CGM,
                        res.BG, res.risk])


def _unpack(planes: np.ndarray) -> dict:
    """Host planes ``[..., len(_PLANES), B]`` by name, the flags as bool."""
    out = {k: planes[..., i, :] for i, k in enumerate(_PLANES)}
    out["terminated"] = out["terminated"] != 0
    out["truncated"] = out["truncated"] != 0
    return out


class _VectorEnv:
    """Vectorized env on the device: B auto-resetting patients, each step
    one batch of eager env ops (the reference runs B gym envs in OS
    processes, sim_engine.py:65-76 via pathos).

    Episodes auto-reset on termination or at the ``horizon_days`` horizon
    with a fresh random start hour and initial BG.  Gymnasium's SAME_STEP
    convention (``metadata['autoreset_mode']`` where gymnasium has it): when
    env i ends, ``step`` returns the new episode's reset observation for env
    i and carries the terminal step in ``info["final_observation"][i]`` /
    ``info["final_info"][i]``.  :meth:`step_n` runs N policy-driven steps
    with one copy to the host.

    Spans (:mod:`simglucose_tpu_torch.utils.profiling`, recorded only under
    a profiler session): ``env.reset`` around :meth:`reset`; ``env.step``
    around :meth:`step`, counting its ``lanes`` and the envs whose episode
    ``ended``; ``env.advance`` around the eager ops' issue and
    ``env.fetch`` around the copy to the host, counting its ``bytes``, in
    :meth:`step` and :meth:`step_n` alike."""

    metadata = {"render_modes": []}

    def __init__(
        self,
        num_envs: int,
        patient_names: Optional[Sequence[str]] = None,
        reward_fun: Optional[Callable] = None,
        seed: int = 0,
        sensor: str = "Dexcom",
        pump: str = "Insulet",
        dtype=torch.float32,
        substeps: int = 1,
        horizon_days: float = 10.0,
        device="cuda",
    ):
        if patient_names is None:
            patient_names = tables.cohort_names(num_envs)
        if len(patient_names) != num_envs:
            raise ValueError(f"got {len(patient_names)} patient names for {num_envs} envs")
        self.num_envs = num_envs
        self.patient_names = list(patient_names)
        self.device = check_device(device)
        self._dtype = torch_dtype(dtype)
        self.cfg, self._params = make_env(
            self.patient_names, sensor=sensor, pump=pump, dtype=self._dtype, batch=True,
            substeps=substeps, random_init_bg=True, device=self.device,
        )
        self._max_basal = float(tables.pump_record(pump)["max_basal"])
        gym = _gymnasium()
        if gym is not None and hasattr(gym.vector, "AutoresetMode"):
            # Gymnasium 1.x autoreset contract declaration
            self.metadata = dict(self.metadata, autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        self.horizon_steps = int(horizon_days * 24 * 60 // self.cfg.sample_time)
        self._reward = _wrap_reward(reward_fun, self.cfg.window_size)
        self._seed = seed
        self._state = None
        self._last_obs = None

    @property
    def single_action_space(self):
        return _box(self._max_basal, (1,))

    @property
    def single_observation_space(self):
        return _box(np.inf, (1,))

    @property
    def action_space(self):
        return _box(self._max_basal, (self.num_envs, 1))

    @property
    def observation_space(self):
        return _box(np.inf, (self.num_envs, 1))

    @span("env.reset")
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        """Fresh episodes for every env, keyed ``env_keys(seed, num_envs)``
        (lane b's streams are the seed's at lane b), each at a random start
        hour."""
        if seed is not None:
            self._seed = seed
        keys = env_keys(self._seed, self.num_envs, device=self.device)
        self._state, res = batch_reset(self.cfg, self._params, keys)
        # the reset observation is the second reset-time sensor sample
        # (env.py:142), as step()'s carry exposes after an auto-reset
        self._last_obs = res.observation.CGM
        h = to_host(torch.stack([res.observation.CGM, res.BG])).numpy()
        return h[0].astype(np.float32)[:, None], {"bg": h[1]}

    def _step(self, basal: torch.Tensor):
        with span("env.advance"):
            act = CtrlAction(basal=basal, bolus=torch.zeros_like(basal))
            self._state, res, carry, trunc = autoreset_step(
                self.cfg, self._params, self._state, act, reward_fun=self._reward,
                horizon_steps=self.horizon_steps)
            self._last_obs = carry.observation.CGM
            return _step_planes(res, carry, trunc)

    @staticmethod
    def _fetch(planes: torch.Tensor) -> np.ndarray:
        """The planes on the host (:func:`~simglucose_tpu_torch.core.device.to_host`)."""
        with span("env.fetch"):
            count("bytes", planes.numel() * planes.element_size())
            return to_host(planes).numpy()

    @span("env.step")
    def step(self, actions):
        count("lanes", self.num_envs)
        basal = torch.as_tensor(actions, dtype=self._dtype, device=self.device).reshape(self.num_envs)
        p = _unpack(self._fetch(self._step(basal)))
        done, trunc = p["terminated"], p["truncated"]
        info = {"bg": p["bg"], "meal": p["meal"], "insulin": p["insulin"], "risk": p["risk"]}
        ended = done | trunc
        idx = np.flatnonzero(ended)
        count("ended", idx.size)
        if idx.size:
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            for i in idx:
                final_obs[i] = np.asarray([p["final_obs"][i]], np.float32)
                final_info[i] = {"bg": p["final_bg"][i], "risk": p["final_risk"][i]}
            info["final_observation"] = final_obs
            info["_final_observation"] = ended.copy()
            info["final_info"] = final_info
            info["_final_info"] = ended.copy()
        return p["obs"].astype(np.float32)[:, None], p["reward"], done, trunc, info

    def step_n(self, n: int, policy: Callable):
        """Run ``n`` policy-driven steps; one copy to the host at the end.

        ``policy(obs)`` maps the ``[B, 1]`` CGM observation, a tensor on
        the device, to ``[B, 1]`` (or ``[B]``) basal actions on the device.
        The steps are a Python loop of auto-reset env steps (the JAX
        package's ``lax.scan`` of them), with the semantics of :meth:`step`;
        nothing in the loop waits for the device, and the outputs are
        stacked on the device and copied to the host once.  There is no
        compiled program, so (unlike the JAX env) nothing is cached per
        ``(n, policy)``, and a policy may change its weights between calls.

        Returns ``(obs [n,B,1], rewards [n,B], terminated [n,B],
        truncated [n,B], infos)``: ``infos`` carries the ``bg`` / ``risk``
        planes of the observed results and ``final_observation`` /
        ``final_info`` planes ``[n, B]``, valid where
        ``terminated | truncated`` (``final_observation`` NaN elsewhere)."""
        outs = []
        for _ in range(n):
            a = torch.as_tensor(policy(self._last_obs[:, None]), dtype=self._dtype,
                                device=self.device)
            outs.append(self._step(a.reshape(-1)))
        p = _unpack(self._fetch(torch.stack(outs)))
        ended = p["terminated"] | p["truncated"]
        infos = {
            "bg": p["bg"],
            "risk": p["risk"],
            "final_observation": np.where(ended, p["final_obs"], np.nan),
            "_final_observation": ended,
            "final_info": {"bg": p["final_bg"], "risk": p["final_risk"]},
            "_final_info": ended,
        }
        return p["obs"][:, :, None], p["reward"], p["terminated"], p["truncated"], infos

    def close(self, **kwargs):
        pass


def __getattr__(name):
    """``T1DSimGymEnv`` / ``T1DSimVectorEnv``, built at first use on their
    gymnasium base class where gymnasium imports, else on the plain class
    alone."""
    if name not in ("T1DSimGymEnv", "T1DSimVectorEnv"):
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    single = name == "T1DSimGymEnv"
    core = _GymEnv if single else _VectorEnv
    gym = _gymnasium()
    bases = (core,) if gym is None else (core, gym.Env if single else gym.vector.VectorEnv)
    cls = type(name, bases, {"__module__": __name__, "__qualname__": name, "__doc__": core.__doc__})
    globals()[name] = cls
    return cls


def register_envs():
    """Register the Gymnasium ids (reference: simglucose/__init__.py:1-6
    registers 'simglucose-v0').  ``simglucose_tpu_torch/T1DSim-v0`` is the
    port's; ``simglucose-v0`` is registered only where the id is free, so
    that the JAX package's registration of it stands.  Safe to call
    repeatedly; a no-op without gymnasium."""
    if _gymnasium() is None:
        return
    from gymnasium.envs.registration import register, registry

    for env_id in ("simglucose_tpu_torch/T1DSim-v0", "simglucose-v0"):
        if env_id not in registry:
            register(id=env_id, entry_point="simglucose_tpu_torch.envs.gym_env:T1DSimGymEnv")
