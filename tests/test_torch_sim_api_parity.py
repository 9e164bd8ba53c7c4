"""A port SimObj against a JAX SimObj in the reference-verification
configuration: one patient, 3 h from 06:00 (breakfast falls in it), BB,
``compat_mode=True`` (the reference's MT19937 noise and meals, float64, rk45
at 4 substeps) on the eager env path / JAX's XLA engine.  Tolerances are
tests/test_torch_env_golden.py's: BG rtol 5e-8, CGM atol 1e-5, CHO and
insulin rtol 1e-12, the risk indices rtol 1e-5."""
from datetime import datetime, timedelta

import numpy as np
import torch

from simglucose_tpu.sim import SimObj as JSimObj
from simglucose_tpu_torch.sim import SimObj

torch.set_num_threads(1)


def test_compat_sim_obj_matches_jax():
    kw = dict(controller="BB", sim_time=timedelta(hours=3), start_time=datetime(2018, 1, 1, 6),
              seed=1, cgm_seed=1, compat_mode=True, engine="xla")
    want = JSimObj("adolescent#001", **kw).simulate()
    got = SimObj("adolescent#001", device="cpu", **kw).simulate()
    assert list(got.columns) == list(want.columns) and (got.index == want.index).all()
    assert len(got) == 3 * 60 // 3 + 1 and got.BG.dtype == np.float64
    assert got.CHO.sum() > 0  # a meal was eaten
    np.testing.assert_allclose(got.BG, want.BG, rtol=5e-8)
    np.testing.assert_allclose(got.CGM, want.CGM, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.CHO, want.CHO, rtol=1e-12)
    np.testing.assert_allclose(got.insulin, want.insulin, rtol=1e-12)
    for f in ("LBGI", "HBGI", "Risk"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-10, err_msg=f)
