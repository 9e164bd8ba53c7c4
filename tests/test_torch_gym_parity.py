"""A compat ``T1DSimGymEnv`` of the port against the JAX package's at seed
0: the reference's MT19937 noise, meals and initial state, float64, rk45 at
4 substeps, 24 steps of a fixed basal.  Start time exact (2018-01-01
23:00, the reference's contract); tolerances are
tests/test_torch_env_golden.py's: BG and the patient state rtol 5e-8, CGM
(and the observation, a float32 of it) atol 1e-5, CHO and insulin rtol
1e-12, the risk indices rtol 1e-5; the reward, a difference of two risk
indices of CGM, atol 1e-5."""
from datetime import datetime

import numpy as np
import torch

from simglucose_tpu.envs.gym_env import T1DSimGymEnv as JGymEnv
from simglucose_tpu_torch.envs.gym_env import T1DSimGymEnv

torch.set_num_threads(1)


def _episode(env, n=24):
    obs, info = env.reset()
    rows = [(obs, 0.0, False, False, info)]
    for k in range(n):
        rows.append(env.step(np.asarray([0.01 + 0.001 * (k % 5)])))
    return rows


def test_compat_episode_matches_jax():
    kw = dict(patient_name="adolescent#001", seed=0, compat_mode=True, horizon_days=1)
    jenv = JGymEnv(**kw)
    want = _episode(jenv)
    env = T1DSimGymEnv(device="cpu", **kw)
    got = _episode(env)
    assert env.start_time == datetime(2018, 1, 1, 23, 0, 0)
    assert env._state.patient.x.dtype == torch.float64
    for k, ((o, r, d, tr, i), (jo, jr, jd, jtr, ji)) in enumerate(zip(got, want)):
        msg = f"step {k}"
        assert (d, tr) == (bool(jd), bool(jtr)) and i["time"] == ji["time"], msg
        assert o.dtype == np.float32 and o.shape == (1,), msg
        np.testing.assert_allclose(o, jo, rtol=0, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(r, jr, rtol=0, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(i["bg"], ji["bg"], rtol=5e-8, err_msg=msg)
        np.testing.assert_allclose(i["patient_state"], np.asarray(ji["patient_state"]), rtol=5e-8,
                                   atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(i["meal"], ji["meal"], rtol=1e-12, err_msg=msg)
        for f in ("lbgi", "hbgi", "risk"):
            np.testing.assert_allclose(i[f], ji[f], rtol=1e-5, atol=1e-10, err_msg=f"{msg} {f}")
    hist, jhist = env.show_history(), jenv.show_history()
    assert (hist.index == jhist.index).all() and len(hist) == 25
    np.testing.assert_allclose(hist.BG, jhist.BG, rtol=5e-8)
    np.testing.assert_allclose(hist.CGM, jhist.CGM, rtol=0, atol=1e-5)
    np.testing.assert_allclose(hist.insulin, jhist.insulin, rtol=1e-12)
