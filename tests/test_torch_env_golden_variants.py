"""The closed-loop goldens of other patients and sensors on the port's
eager env path: adult#005 with GuardianRT (5-min samples) and child#003
with Navigator (1-min samples), 24 h each, compat configuration (the
reference's MT19937 streams, float64, rk45 at 4 substeps), against
tests/golden/closedloop_*.npz at tests/test_env_golden_variants.py's
tolerances: BG rtol 5e-7, CGM atol 1e-4, CHO rtol 1e-12, insulin rtol
1e-9, risk rtol 1e-4."""
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
from simglucose_tpu_torch.params import load_quest_params, sensor_record, sensor_sample_time

from conftest import load_golden

torch.set_num_threads(1)

CONFIGS = [
    ("adult#005", "GuardianRT", 2, 2, "closedloop_adult_005_GuardianRT.npz"),
    ("child#003", "Navigator", 3, 5, "closedloop_child_003_Navigator.npz"),
]


@pytest.mark.parametrize("pname,sname,cgm_seed,scen_seed,fixture", CONFIGS,
                         ids=[c[4].split(".")[0] for c in CONFIGS])
def test_closedloop_variant_golden(pname, sname, cgm_seed, scen_seed, fixture):
    g = load_golden(fixture)
    st = sensor_sample_time(sname)
    n_steps = 24 * 60 // st
    noise = reference_cgm_noise(sensor_record(sname), cgm_seed, n_steps + 2)
    meals = reference_meal_seq(scen_seed, datetime(2018, 1, 1, 0, 0, 0), n_steps * st + 1)
    cfg, params = make_env(pname, sensor=sname, dtype=np.float64, noise_seq=noise, meal_seq=meals,
                           substeps=4, method="rk45", device="cpu")
    quest = tree_map(lambda a: a[0], load_quest_params(pname, dtype=torch.float64, device="cpu"))
    ctrl0, ctrl = bb_controller(bb_params(params.patient, quest), cfg.sample_time)
    _, reset, traj = rollout(cfg, params, env_keys(0, 1, device="cpu")[0], ctrl0, ctrl, n_steps)

    row = lambda f: np.concatenate([[float(getattr(reset, f))], getattr(traj, f).numpy()])
    bg, cgm = row("BG"), row("CGM")
    assert len(bg) == len(g["BG"])
    np.testing.assert_allclose(bg, g["BG"], rtol=5e-7)
    np.testing.assert_allclose(cgm, g["CGM"], atol=1e-4)
    np.testing.assert_allclose(traj.CHO.numpy(), g["CHO"][:-1], rtol=1e-12)
    np.testing.assert_allclose(traj.insulin.numpy(), g["insulin"][:-1], rtol=1e-9)
    np.testing.assert_allclose(row("risk"), g["Risk"], rtol=1e-4, atol=1e-9)
    assert float(traj.CHO.sum()) > 0
