"""The 30-patient cohort golden through the port's user-facing entry:
``simulate_cohort(compat_mode=True, device="cpu")`` (the eager env path,
float64, rk45 at 4 substeps, the reference's MT19937 noise and meals shared
by the cohort) against tests/golden/cohort_golden.npz, and, where pandas is
installed, ``simulate()``'s frame and the port's report against the
reference's CSVs.

Config and tolerances are tests/test_cohort_golden.py's: 30 patients x 24
h, BB, Dexcom cgm_seed=1, RandomScenario seed 1, start 2018-01-01 00:00;
BG rtol 1e-5, CGM atol 1e-3, CHO rtol 1e-12, insulin rtol 1e-12 or one pump
increment (a BB bolus that the reference's adaptive integrator puts across
a rounding boundary), risk rtol 1e-4 / atol 1e-3; report counts exact,
LBGI/HBGI rtol 1e-3 / atol 1e-4."""
import functools
import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from conftest import GOLDEN

from simglucose_tpu_torch.analysis.report import cohort_frame, report
from simglucose_tpu_torch.params import patient_names
from simglucose_tpu_torch.sim.engine import simulate, simulate_cohort

torch.set_num_threads(1)

RUN = dict(sim_time=timedelta(days=1), scenario_seed=1, cgm_seed=1,
           start_time=datetime(2018, 1, 1, 0, 0, 0), compat_mode=True, device="cpu")


@functools.lru_cache(maxsize=1)
def _cohort():
    return simulate_cohort(**RUN)


def _golden():
    return np.load(os.path.join(GOLDEN, "cohort_golden.npz"))


def test_cohort_traces_match_reference_batch_sim():
    g = _golden()
    res = _cohort()
    names = patient_names()
    assert sorted({k.split("/")[0] for k in g.files}) == sorted(names)
    assert res.traj.BG.dtype == np.float64
    for b, name in enumerate(names):
        row = lambda f: np.concatenate([[getattr(res.reset, f)[b]], getattr(res.traj, f)[:, b]])
        bg = row("BG")
        assert len(bg) == len(g[f"{name}/BG"]) == 481
        np.testing.assert_allclose(bg, g[f"{name}/BG"], rtol=1e-5, err_msg=f"{name}:BG")
        np.testing.assert_allclose(row("CGM"), g[f"{name}/CGM"], atol=1e-3, err_msg=f"{name}:CGM")
        np.testing.assert_allclose(res.traj.CHO[:, b], g[f"{name}/CHO"][:-1], rtol=1e-12,
                                   err_msg=f"{name}:CHO")
        np.testing.assert_allclose(res.traj.insulin[:, b], g[f"{name}/insulin"][:-1], rtol=1e-12,
                                   atol=0.05 / 6000 * 1.01, err_msg=f"{name}:insulin")
        np.testing.assert_allclose(row("risk"), g[f"{name}/Risk"], rtol=1e-4, atol=1e-3,
                                   err_msg=f"{name}:Risk")
    assert np.isfinite(res.reward).all() and res.reward.shape == (480, 30)


def test_cohort_report_stats_match_reference(tmp_path):
    """simulate()'s frame through the port's report(): the reference's
    performance_stats / risk_trace / CVGA_stats CSVs."""
    pd = pytest.importorskip("pandas")
    res = _cohort()
    df = cohort_frame(res.reset, res.traj, patient_names(), RUN["start_time"], res.sample_time)
    report(df, save_path=str(tmp_path))
    ref_stats = pd.read_csv(os.path.join(GOLDEN, "cohort_performance_stats.csv"), index_col=0)
    ours = pd.read_csv(tmp_path / "performance_stats.csv", index_col=0)
    assert list(ours.index) == list(ref_stats.index)
    for c in ref_stats.columns:
        tol = dict(rtol=0, atol=1e-9) if "BG" in c and "GI" not in c else dict(rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(ours[c].to_numpy(), ref_stats[c].to_numpy(), err_msg=c, **tol)
    ref_risk = pd.read_csv(os.path.join(GOLDEN, "cohort_risk_trace.csv"), index_col=[0, 1])
    ours_risk = pd.read_csv(tmp_path / "risk_trace.csv", index_col=[0, 1])
    np.testing.assert_allclose(ours_risk.to_numpy(), ref_risk.to_numpy(), rtol=1e-3, atol=1e-4)
    ref_cvga = pd.read_csv(os.path.join(GOLDEN, "cohort_CVGA_stats.csv"), index_col=0)
    ours_cvga = pd.read_csv(tmp_path / "CVGA_stats.csv", index_col=0)
    for z in ("A", "B", "C", "D", "E"):
        np.testing.assert_allclose(ours_cvga[z].to_numpy(), ref_cvga[z].to_numpy(), atol=1e-9, err_msg=z)


def test_simulate_frame_is_the_cohort_planes(tmp_path):
    """simulate(compat_mode=True) on a short horizon: the frame's rows are
    simulate_cohort's planes, and save_path writes a CSV per patient."""
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    names = ["adolescent#001", "child#003"]
    kw = dict(RUN, sim_time=timedelta(hours=2), patient_names=names)
    df = simulate(save_path=str(tmp_path), **kw)
    res = simulate_cohort(**kw)
    for b, n in enumerate(names):
        np.testing.assert_array_equal(df.loc[n].BG.to_numpy()[1:], res.traj.BG[:, b])
        assert (tmp_path / f"{n}.csv").exists()
    assert df.attrs["reward"].shape == (40, 2)
