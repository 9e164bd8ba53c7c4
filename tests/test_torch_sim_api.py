"""The port's object API over the cohort engine (``SimObj``, ``sim``,
``batch_sim``; JAX ``sim/engine.py:982-1086``) and the ``utils`` lookups,
on the CPU: tests/test_sim_api.py's two SimObj tests at ``device="cpu"``;
a fusable batch is one ``simulate_cohort`` call whose planes are the direct
call's, bit for bit; and the JAX package's fuse-key fault, which the port
does not copy: there a PID and a BB SimObj key alike (``type(controller)
.__name__`` is ``"tuple"`` for both) and run as one cohort under the first
one's controller; here they make two calls, each equal to its own
``sim``."""
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest
import torch

import simglucose_tpu.sim as jsim
from simglucose_tpu import utils as jutils
from simglucose_tpu_torch import sim as tsim
from simglucose_tpu_torch import utils as tutils
from simglucose_tpu_torch.sim import SimObj, batch_sim, engine, sim
from simglucose_tpu_torch.sim.engine import simulate_cohort

torch.set_num_threads(1)

TWO_H = dict(sim_time=timedelta(hours=2), start_time=datetime(2018, 1, 1), device="cpu")


@pytest.fixture
def cohort_calls(monkeypatch):
    """The controllers of the engine's simulate_cohort calls, in order."""
    seen = []
    real = engine.simulate_cohort

    def counting(**kw):
        seen.append(kw["controller"])
        return real(**kw)

    monkeypatch.setattr(engine, "simulate_cohort", counting)
    return seen


def test_sim_obj_and_batch_fusion(tmp_path, cohort_calls):
    names = ("adolescent#001", "adolescent#002")
    objs = [SimObj(patient_name=n, controller="BB", seed=1, path=str(tmp_path), **TWO_H)
            for n in names]
    results = batch_sim(objs, parallel=True)
    assert len(results) == 2 and cohort_calls == ["BB"]
    for r, n in zip(results, names):
        assert len(r) == 2 * 60 // 3 + 1
        assert (tmp_path / f"{n}.csv").exists()


def test_batch_sim_matches_individual_sim():
    """Fused cohort == per-patient runs (reference: tests/test_sim_engine.py:
    24-86 parallel == serial).  A patient's streams are keyed by its lane in
    its cohort, so only BG is held: in two hours from midnight no meal slot
    opens, and BB doses from the meals only."""
    mk = lambda n: SimObj(patient_name=n, controller="BB", seed=3, **TWO_H)
    names = ["adolescent#001", "child#002"]
    fused = batch_sim([mk(n) for n in names])
    singles = [sim(mk(n)) for n in names]
    for f, s in zip(fused, singles):
        np.testing.assert_allclose(np.asarray(f.BG), np.asarray(s.BG), rtol=1e-6)


def test_a_fusable_batch_is_one_cohort_call(cohort_calls):
    """Three instances that differ only in the patient: one simulate_cohort
    call, its planes the direct call's, split per patient in order."""
    names = ["adult#001", "child#003", "adolescent#004"]
    objs = [SimObj(n, controller=None, seed=5, cgm_seed=6, **TWO_H) for n in names]
    (res, idx), = engine._batch_cohorts(objs)
    assert idx == [0, 1, 2] and cohort_calls == [None]
    direct = simulate_cohort(patient_names=names, sim_time=TWO_H["sim_time"],
                             start_time=TWO_H["start_time"], scenario_seed=5, cgm_seed=6,
                             device="cpu")
    for a, b in zip(res.reset + res.traj, direct.reset + direct.traj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.reward, direct.reward)
    frames = batch_sim(objs)
    for b, f in enumerate(frames):
        np.testing.assert_array_equal(f.CGM.to_numpy()[1:], direct.traj.CGM[:, b])


def test_pid_and_bb_run_as_two_cohorts(cohort_calls):
    """The JAX package's fault, not copied: ('PID', {...}) and ('BB', {...})
    are two calls, each SimObj's frame equal to its own sim()."""
    pid = ("PID", dict(P=-2e-4, I=-1e-7))
    bb = ("BB", dict(target=120.0))
    mk = lambda n, c: SimObj(n, controller=c, seed=2, scenario=[(0.5, 40.0)], **TWO_H)
    fused = batch_sim([mk("adolescent#001", pid), mk("adult#001", bb)])
    assert cohort_calls == [pid, bb]
    for frame, (n, c) in zip(fused, (("adolescent#001", pid), ("adult#001", bb))):
        pd.testing.assert_frame_equal(frame, sim(mk(n, c)))
    # the two controllers act differently on the same patient
    a, b = batch_sim([mk("adult#001", pid), mk("adult#001", bb)])
    assert not np.array_equal(a.insulin.to_numpy(), b.insulin.to_numpy())


def test_fuse_key_rules():
    """A name (or None) fuses by value; any other controller, and a kwarg
    that does not hash, only by identity; a custom scenario by value."""
    key = lambda **kw: SimObj("adult#001", **kw)._fuse_key()
    pid = ("PID", dict(P=-1e-4))
    assert key(controller="PID") == key(controller="PID")
    assert key(controller=pid) == key(controller=pid)
    assert key(controller=pid) != key(controller=("PID", dict(P=-1e-4)))
    assert key(controller=pid) != key(controller=("BB", {}))
    assert key(scenario=[(1, 20.0)]) == key(scenario=[(1, 20.0)])
    gains = [1.0]
    assert key(extra=gains) == key(extra=gains) and key(extra=gains) != key(extra=[1.0])
    assert key(cgm_seed=4) == key(cgm_seed=4) != key(cgm_seed=5)
    assert key(device="cpu") != key(device="cuda")


def test_save_results_writes_the_frame(tmp_path):
    o = SimObj("child#001", controller="PID", path=str(tmp_path), **TWO_H)
    with pytest.raises(ValueError, match="path not set"):
        SimObj("child#001", **TWO_H).save_results()
    df = sim(o)
    back = pd.read_csv(tmp_path / "child#001.csv", index_col="Time", parse_dates=["Time"])
    assert list(back.columns) == ["BG", "CGM", "CHO", "insulin", "LBGI", "HBGI", "Risk"]
    np.testing.assert_allclose(back.to_numpy(), df.to_numpy(), rtol=1e-6)
    assert (back.index == df.index).all()
    assert o.results() is df


def test_entry_defaults_and_animate():
    """SimObj runs on the card unless asked (raising where there is none);
    animate=True draws as simulate(animate=True) does, and its frame is the
    unanimated one."""
    import matplotlib

    matplotlib.use("Agg")
    drawn = SimObj("adult#001", animate=True, **TWO_H).simulate()
    pd.testing.assert_frame_equal(drawn, SimObj("adult#001", **TWO_H).simulate())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimObj("adult#001", sim_time=timedelta(hours=1)).simulate()


def test_sim_package_exports():
    assert tsim.__all__ == jsim.__all__ == ["simulate", "SimObj", "sim", "batch_sim"]
    assert tsim.simulate is engine.simulate and tsim.SimObj is SimObj


@pytest.mark.parametrize("name", ["adolescent#001", "adult#010", "child#007"])
def test_utils_lookups_match_jax(name):
    assert tutils.fetch_patient_params(name) == jutils.fetch_patient_params(name)
    assert tutils.fetch_patient_quest(name) == jutils.fetch_patient_quest(name)
    assert tutils.fetch_patient_quest("nobody") == jutils.fetch_patient_quest("nobody")
    df = pd.DataFrame([tutils.fetch_patient_quest(n) for n in ("adult#001", name)])
    assert tutils.lookup_patient_meta_data(df, name) == jutils.lookup_patient_meta_data(df, name)
