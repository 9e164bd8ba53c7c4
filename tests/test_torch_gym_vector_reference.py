"""The port's Gymnasium vector env, ``envs/gym_env.py::T1DSimVectorEnv`` on
the CPU, held to the plain reference of simglucose's env
(``benchmark/reference/env.py``, which imports nothing of the port):
12 envs for 300 steps from ``reset(seed=...)`` under seeded actions, with
overdoses in four envs that end their episodes below 70 mg/dL, a horizon
of 12 hours that truncates the others, and midnights that redraw the
day's meal plan, whose meals are then eaten.  Every
plane the agent reads after a step, and the terminal step's
``final_observation`` / ``final_info``, is compared.

The tolerances are tight because on one CPU both sides do the same
float32 arithmetic but for the sensor's Johnson transform (the program's
sinh, the reference's exponentials), which moves a CGM sample by a few
ulps: CGM to a relative 1e-5 and the reward, a difference of two risks of
CGM, to 1e-3; BG, its risk, meals, insulin and the flags as computed.  A
change of the law (a stream, an order of a step's parts, a reset) moves
the planes by orders of magnitude more.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import env as ref
from benchmark.reference import tables as rt
from simglucose_tpu_torch.envs.gym_env import T1DSimVectorEnv

torch.set_num_threads(1)

B, T, HORIZON_DAYS, SEED = 12, 300, 0.5, 20261018
# (absolute, relative) of each plane; the finals as their plane
TOL = dict(obs=(0.0, 1e-5), reward=(1e-3, 0.0), terminated=(0.0, 0.0), truncated=(0.0, 0.0),
           bg=(0.0, 1e-6), risk=(1e-4, 1e-6), meal=(1e-6, 0.0), insulin=(1e-9, 0.0),
           final_obs=(0.0, 1e-5), final_bg=(0.0, 1e-6), final_risk=(1e-4, 1e-6))


def _actions(rng, t: int) -> np.ndarray:
    """An agent's basal (0.2 U/min x sigmoid of a Gaussian around -2.2),
    in envs 0-3 eight times over for 8 steps of every 60: overdoses that
    end episodes below 70 mg/dL."""
    a = 0.2 / (1.0 + np.exp(-(-2.2 + 0.6 * rng.standard_normal(B))))
    a[:4] *= 8.0 if t % 60 < 8 else 1.0
    return a.astype(np.float32)[:, None]


@pytest.fixture(scope="module")
def runs():
    env = T1DSimVectorEnv(B, seed=3, device="cpu", horizon_days=HORIZON_DAYS)
    obs0, info0 = env.reset(seed=SEED)
    rng = np.random.default_rng(7)
    actions, planes, finals = [], [], []
    redrawn = np.zeros(B, dtype=bool)  # the episode has redrawn its plan at a midnight
    meals_after_midnight = 0
    for t in range(T):
        day = env._state.scenario.day.clone()
        a = _actions(rng, t)
        obs, reward, term, trunc, info = env.step(a)
        # a midnight redraw: the plan's day moved on within an episode
        redrawn = (redrawn | (env._state.scenario.day > day).numpy()) & ~(term | trunc)
        meals_after_midnight += int((redrawn & (info["meal"] > 0)).sum())
        actions.append(a[:, 0])
        planes.append(dict(obs=obs[:, 0], reward=reward, terminated=term, truncated=trunc,
                           bg=info["bg"], risk=info["risk"], meal=info["meal"],
                           insulin=info["insulin"]))
        fin = {k: np.full(B, np.nan) for k in ref.FINALS}
        if "final_observation" in info:
            for i in np.flatnonzero(info["_final_observation"]):
                fin["final_obs"][i] = info["final_observation"][i][0]
                fin["final_bg"][i] = info["final_info"][i]["bg"]
                fin["final_risk"][i] = info["final_info"][i]["risk"]
        finals.append(fin)
    names = [rt.patient_names()[i % 30] for i in range(B)]
    c = ref.env_config(rt.by_name("sensor")["Dexcom"], rt.by_name("pump")["Insulet"],
                       HORIZON_DAYS)
    want = ref.run(c, rt.patients(names, "cpu"), SEED, torch.arange(B),
                   torch.as_tensor(np.stack(actions)))
    got = {k: np.stack([p[k] for p in planes]) for k in ref.PLANES}
    got.update({k: np.stack([f[k] for f in finals]) for k in ref.FINALS})
    return dict(got=got, want={k: v.double().numpy() for k, v in want.items()}, obs0=obs0,
                bg0=info0["bg"], meals_after_midnight=meals_after_midnight)


def _within(got, want, tol) -> np.ndarray:
    a, r = tol
    return np.abs(np.asarray(got, np.float64) - want) <= a + r * np.abs(want)


def test_the_reset_matches(runs):
    assert _within(runs["obs0"][:, 0], runs["want"]["obs0"], TOL["obs"]).all()
    assert _within(runs["bg0"], runs["want"]["bg0"], TOL["bg"]).all()


@pytest.mark.parametrize("plane", ref.PLANES)
def test_every_step_matches(runs, plane):
    ok = _within(runs["got"][plane], runs["want"][plane], TOL[plane])
    bad = np.argwhere(~ok)
    assert ok.all(), f"{plane} off at (step, env) {bad[:5].tolist()}"


@pytest.mark.parametrize("final", ref.FINALS)
def test_the_terminal_steps_match(runs, final):
    ended = runs["got"]["terminated"] | runs["got"]["truncated"]
    assert ended.any()
    ok = _within(runs["got"][final][ended], runs["want"][final][ended], TOL[final])
    assert ok.all(), final


def test_the_run_ends_episodes_both_ways_and_crosses_midnights(runs):
    got = runs["got"]
    assert got["terminated"].sum() >= 3 and (got["bg"][got["terminated"]] > 0).all()
    assert (runs["want"]["final_bg"][got["terminated"]] < 70.0).any()
    assert got["truncated"].sum() >= 1
    assert runs["meals_after_midnight"] >= 1
    # an ended env's next observation is its new episode's reset observation
    assert (got["meal"][got["terminated"] | got["truncated"]] == 0).all()
