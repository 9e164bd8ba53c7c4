"""An RL user's agent stepping simglucose's Gymnasium env as a vector env:
``envs/gym_env.py::T1DSimVectorEnv`` of ``num_envs`` patients (the 30
cycled) on the card, one ``step(action)`` a call, closed loop, as CleanRL's
``ppo_continuous_action.py`` steps its envs: the agent, an MLP on the same
card, acts on the last numpy observation (``torch.as_tensor`` to the
card), its actions go to ``step`` as ``actions.cpu().numpy()``, and
``step`` returns numpy ``obs, reward, terminated, truncated, info``.  A
call is ``num_envs`` env-steps.

Set-up builds the env and the agent from the seed, warms every shape with
``warm_steps`` steps, then calls ``reset(seed=...)`` with a seed drawn from
``--seed``, so that the window starts from fresh episodes the reference can
replay.

The check: ``check_lanes`` lanes drawn from the seed have the actions they
received (float32, after the numpy round trip) and the planes ``step``
gave back recorded at every window step, a slice of the arrays ``step``
returns anyway; ``check_steps`` window steps are drawn from the seed as
the calls complete.  After the window the card is freed and the reference
(:mod:`benchmark.reference.env`) replays those lanes on the host's CPU
(``check_threads`` threads) from the reset, with the recorded actions, up
to the last drawn step; every step is compared.

Workload keys: ``num_envs``, ``warm_steps``, ``check_lanes``,
``check_steps``, ``check_threads``, ``control_steps`` (the open-loop
control's length).  The configuration gives the env and the agent.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark.harness import draws
from benchmark.harness.runner import Runner, free_cuda
from benchmark.reference import env as ref
from benchmark.reference import tables as ref_tables

# a recorded step's rows: the action, then the planes the agent reads
ROWS = ("action",) + ref.PLANES


def env_config(conf: dict) -> ref.EnvConfig:
    return ref.env_config(ref_tables.by_name("sensor")[conf["sensor"]],
                          ref_tables.by_name("pump")[conf["pump"]], conf["horizon_days"])


def names_of(lanes) -> list:
    base = ref_tables.patient_names()
    return [base[int(i) % len(base)] for i in lanes]


def replay(conf: dict, seed: int, lanes, actions, dtype=torch.float32) -> dict:
    """The reference's planes of ``lanes`` after ``reset(seed=seed)`` and
    the ``[T, L]`` ``actions``, on the host's CPU."""
    lanes = torch.as_tensor(np.asarray(lanes), dtype=torch.int64)
    return ref.run(env_config(conf), ref_tables.patients(names_of(lanes.tolist()), "cpu", dtype),
                   seed, lanes, torch.as_tensor(np.asarray(actions), dtype=torch.float32), dtype)


def tolerance(conf: dict) -> dict:
    """How far each plane may stand from the reference's: BG and CGM to a
    relative 1e-3 (float32 over an episode, and the program's sinh of the
    Johnson transform where the reference takes exponentials); risk and
    reward to 0.01 + a relative 1e-3; meals to 1e-6; the insulin to half
    the pump's increment (both sides quantize the same float32 action);
    the flags exactly.  ``(absolute, relative)`` a plane."""
    inc = ref_tables.by_name("pump")[conf["pump"]]["inc_basal"] / 6000.0
    return dict(obs=(0.0, 1e-3), bg=(0.0, 1e-3), reward=(0.01, 1e-3), risk=(0.01, 1e-3),
                meal=(1e-6, 1e-6), insulin=(0.5 * inc, 0.0), terminated=(0.0, 0.0),
                truncated=(0.0, 0.0), final_obs=(0.0, 1e-3), final_bg=(0.0, 1e-3),
                final_risk=(0.01, 1e-3))


def _off(got, want, tol) -> np.ndarray:
    """Where ``got`` leaves ``want`` by more than ``tol``, or is not finite."""
    a, r = tol
    return ~(np.abs(got - want) <= a + r * np.abs(want))


def compare(conf: dict, got: np.ndarray, finals: list, want: dict) -> dict:
    """``got`` ``[T, len(ROWS), L]`` the program's recorded steps,
    ``finals`` its ``(step, lane index, final obs, final bg, final risk)``
    where an episode ended; ``want`` the reference's.  Returns the share
    of lanes with a plane off at some step (``lanes_off``) and the median
    lane's largest relative gap of ``info['bg']`` (``bg_gap_median``)."""
    tol = tolerance(conf)
    L = got.shape[2]
    off = np.zeros(L, dtype=bool)
    for j, k in enumerate(ROWS[1:], start=1):
        w = want[k].double().numpy()
        off |= _off(got[:, j], w, tol[k]).any(axis=0)
    for t, j, *vals in finals:
        for k, v in zip(ref.FINALS, vals):
            off[j] |= bool(_off(np.float64(v), float(want[k][t, j]), tol[k]))
    w_bg = want["bg"].double().numpy()
    gap = (np.abs(got[:, ROWS.index("bg")] - w_bg) / np.abs(w_bg)).max(axis=0)
    return {"lanes_off": float(off.mean()), "bg_gap_median": float(np.median(gap))}


class Agent:
    """CleanRL's continuous actor on the card: CGM x ``obs_scale`` -> H ->
    H (tanh) -> the mean, a fixed log std, the action ``action_scale *
    sigmoid(mean + std * noise)`` U/min.  He-initialised from the seed
    (the mean head scaled by 0.01), biases 0 but the mean head's; the
    noise from a generator of its own on the card."""

    def __init__(self, conf: dict, seed: int, device):
        a = conf["agent"]
        H = a["hidden"]
        self.device = device
        gen = torch.Generator(device=device).manual_seed(draws.seed64(seed, "agent"))
        w1, w2, w_mu = torch.split(torch.randn(H + H * H + H, generator=gen, device=device),
                                   [H, H * H, H])
        self.w1 = w1.view(1, H) * math.sqrt(2.0)
        self.w2 = w2.view(H, H) * math.sqrt(2.0 / H)
        self.w_mu = w_mu.view(H, 1) * (math.sqrt(2.0 / H) * 0.01)
        self.b_mu, self.std = a["init_mu_bias"], math.exp(a["init_log_std"])
        self.scale, self.obs_scale = a["action_scale"], a["obs_scale"]
        self.noise = torch.Generator(device=device).manual_seed(draws.seed64(seed, "agent_noise"))

    def act(self, obs: np.ndarray) -> np.ndarray:
        """``[B, 1]`` float32 actions for the ``[B, 1]`` observations."""
        x = torch.as_tensor(obs, device=self.device) * self.obs_scale
        h = torch.tanh(torch.tanh(x @ self.w1) @ self.w2)
        mu = h @ self.w_mu + self.b_mu
        raw = mu + self.std * torch.randn(mu.shape, generator=self.noise, device=self.device)
        return (self.scale * torch.sigmoid(raw)).cpu().numpy()


def control(conf: dict, wl: dict, seed: int) -> dict:
    """The reference in bfloat16 put in the program's place, open loop:
    ``control_steps`` actions a lane drawn from the seed at the agent's
    law with its mean head at its bias, on the lanes a run of ``seed``
    would compare."""
    a = conf["agent"]
    lanes = check_lanes(seed, wl)
    z = draws.rng(seed, "control").standard_normal((wl["control_steps"], len(lanes)))
    actions = (a["action_scale"] / (1.0 + np.exp(-(a["init_mu_bias"] + math.exp(
        a["init_log_std"]) * z)))).astype(np.float32)
    want = replay(conf, reset_seed_of(seed), lanes, actions)
    got, finals = _as_recorded(replay(conf, reset_seed_of(seed), lanes, actions, torch.bfloat16),
                               actions)
    return compare(conf, got, finals, want)


def _as_recorded(r: dict, actions) -> tuple:
    """The reference's planes as the driver records the program's."""
    got = np.stack([np.asarray(actions, np.float64)] + [r[k].double().numpy() for k in ref.PLANES],
                   axis=1)
    ended = r["terminated"] | r["truncated"]
    finals = [(int(t), int(j), *(float(r[k][t, j]) for k in ref.FINALS))
              for t, j in ended.nonzero().tolist()]
    return got, finals


def check_lanes(seed: int, wl: dict) -> np.ndarray:
    B = wl["num_envs"]
    return np.sort(draws.rng(seed, "lanes").choice(B, size=min(wl["check_lanes"], B),
                                                   replace=False))


def reset_seed_of(seed: int) -> int:
    """The seed of the window's ``reset``, a 32-bit word of ``--seed``."""
    return int(draws.rng(seed, "reset").integers(0, 2 ** 32))


class VectorEnvSteps(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        from simglucose_tpu_torch.envs.gym_env import T1DSimVectorEnv

        wl, conf = ctx.workload, ctx.config
        B = wl["num_envs"]
        self.work_per_call = B
        self.env = T1DSimVectorEnv(
            B, seed=int(draws.rng(ctx.seed, "env").integers(0, 2 ** 32)), sensor=conf["sensor"],
            pump=conf["pump"], dtype=torch.float32, substeps=conf["substeps"],
            horizon_days=conf["horizon_days"], device=self.device)
        self.agent = Agent(conf, ctx.seed, self.device)
        obs, _ = self.env.reset()
        for _ in range(wl["warm_steps"]):
            obs = self.env.step(self.agent.act(obs))[0]
        self.reset_seed = reset_seed_of(ctx.seed)
        self.obs, _ = self.env.reset(seed=self.reset_seed)
        self.lanes = check_lanes(ctx.seed, wl)
        self.sample = draws.Reservoir(ctx.seed, wl["check_steps"])
        self.rows, self.finals, self.i = [], [], 0

    def call(self):
        actions = self.agent.act(self.obs)
        obs, reward, terminated, truncated, info = self.env.step(actions)
        if not (np.isfinite(obs).all() and np.isfinite(reward).all()):
            self.failed += 1
        L = self.lanes
        self.rows.append(np.stack([actions[L, 0], obs[L, 0], reward[L], terminated[L],
                                   truncated[L], info["bg"][L], info["risk"][L], info["meal"][L],
                                   info["insulin"][L]]))
        if "final_observation" in info:
            for j in np.flatnonzero(info["_final_observation"][L]):
                fi = info["final_info"][L[j]]
                self.finals.append((self.i, int(j), float(info["final_observation"][L[j]][0]),
                                    float(fi["bg"]), float(fi["risk"])))
        self.sample.offer(self.i)
        self.obs = obs
        self.i += 1

    def check(self, rec):
        wl = self.ctx.workload
        self.env = self.agent = None
        free_cuda()
        torch.set_num_threads(wl["check_threads"])
        T = max(self.sample.chosen) + 1
        self.got = np.stack(self.rows[:T])
        self.got_finals = [f for f in self.finals if f[0] < T]
        t0 = time.perf_counter()
        self.want = replay(self.ctx.config, self.reset_seed, self.lanes, self.got[:, 0])
        print(f"reference: {T} steps x {len(self.lanes)} lanes replayed in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return self.numbers(compare(self.ctx.config, self.got, self.got_finals, self.want))

    def window_readings(self, kind: str):
        """Calibration only, after ``check`` (``benchmark/calibrate.py``
        looks it up by this name): the numbers of the reference put in the
        program's place on the same lanes and actions, in bfloat16
        (``kind='control'``) or with each action applied a step late
        (``'late_action'``: step t takes action t - 1, the first step its
        own).  None for a fault this cell does not plant, such as the
        fused cell's ``'half_batch'``, which ``calibrate.py`` asks every
        cell for."""
        actions = self.got[:, 0]
        dtype = torch.float32
        if kind == "control":
            dtype = torch.bfloat16
        elif kind == "late_action":
            actions = np.concatenate([actions[:1], actions[:-1]])
        else:
            return None
        r = replay(self.ctx.config, self.reset_seed, self.lanes, actions, dtype)
        got, finals = _as_recorded(r, self.got[:, 0])
        return compare(self.ctx.config, got, finals, self.want)


def setup(ctx):
    return VectorEnvSteps(ctx)
