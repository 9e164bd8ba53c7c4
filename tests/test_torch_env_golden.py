"""The canonical oracle on the port: the 2-day closed-loop golden trace
through the eager env path in compat configuration.

tests/test_env_golden.py's config (adolescent#001, Dexcom cgm seed 1,
RandomScenario seed 1, BB, start 2018-01-01 00:00, 2 days: 960 steps) with
the port's copies of the reference's MT19937 streams
(``simglucose_tpu_torch.compat``), float64, rk45 at 4 substeps per minute,
on the CPU, against tests/golden/closedloop_golden.npz directly (no JAX
run).  Tolerances are that test's: BG rtol 5e-8 (the fixed-step rk45
against the reference's adaptive dopri5), CGM atol 1e-5 (BG plus the exact
noise), CHO / insulin rtol 1e-12, risk indices rtol 1e-5; row 0 is the
reset entry, 149.02 / 165.7939493687905."""
import functools
from datetime import datetime

import numpy as np
import pytest
import torch

from simglucose_tpu_torch.compat.noise import reference_cgm_noise
from simglucose_tpu_torch.compat.scenario import reference_meal_seq
from simglucose_tpu_torch.controllers.functional import bb_controller, bb_params
from simglucose_tpu_torch.core.types import tree_map
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.envs.rollout import rollout
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.params import load_quest_params, sensor_record

from conftest import load_golden

torch.set_num_threads(1)

N_STEPS = 2 * 24 * 60 // 3  # 960 env steps (Dexcom 3-min)


@functools.lru_cache(maxsize=1)
def _run():
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, N_STEPS + 2)
    meals = reference_meal_seq(1, datetime(2018, 1, 1, 0, 0, 0), N_STEPS * 3 + 1)
    cfg, params = make_env("adolescent#001", dtype=np.float64, noise_seq=noise, meal_seq=meals,
                           substeps=4, method="rk45", device="cpu")
    quest = tree_map(lambda a: a[0], load_quest_params("adolescent#001", dtype=torch.float64,
                                                         device="cpu"))
    ctrl0, ctrl = bb_controller(bb_params(params.patient, quest), cfg.sample_time)
    key = env_keys(0, 1, device="cpu")[0]
    _, reset, traj = rollout(cfg, params, key, ctrl0, ctrl, N_STEPS)
    return reset, traj


def _with_reset(reset, traj, f):
    return np.concatenate([[float(getattr(reset, f))], getattr(traj, f).numpy()])


def test_closedloop_golden_trace():
    g = load_golden("closedloop_golden.npz")
    reset, traj = _run()
    bg, cgm = _with_reset(reset, traj, "BG"), _with_reset(reset, traj, "CGM")
    assert len(bg) == len(g["BG"]) == 961 and traj.BG.dtype == torch.float64
    assert bg[0] == pytest.approx(149.02, abs=1e-9)
    assert cgm[0] == pytest.approx(165.7939493687905, abs=1e-9)
    np.testing.assert_allclose(bg, g["BG"], rtol=5e-8)
    np.testing.assert_allclose(cgm, g["CGM"], atol=1e-5)
    # the reference's CHO/insulin histories carry a trailing NaN
    np.testing.assert_allclose(traj.CHO.numpy(), g["CHO"][:-1], rtol=1e-12)
    np.testing.assert_allclose(traj.insulin.numpy(), g["insulin"][:-1], rtol=1e-12)
    for f, k in (("LBGI", "LBGI"), ("HBGI", "HBGI"), ("risk", "Risk")):
        np.testing.assert_allclose(_with_reset(reset, traj, f), g[k], rtol=1e-5, atol=1e-10, err_msg=f)


def test_closedloop_never_terminated():
    _, traj = _run()
    assert not traj.done.any()
