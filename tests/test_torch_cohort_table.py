"""The cohort's lanes from the device's patient table
(``sim/engine.py::patient_table``): what they equal and when it is built.

* The lanes a rank gathers from the table by the names' rows equal the
  loaders' chain, ``pack_params(load_patient_params(names), basal_rate(...),
  quest=load_quest_params(names))``, bit for bit, for the 30 patients (128
  lanes), ``cohort_names(16384)`` split as four ranks' lane ranges, a
  cohort of names and ids 1-30, and a reversed cohort; on the CPU, and on
  a CUDA card where there is one (marker ``card``).
* ``simulate_cohort`` over the mixed cohort equals
  ``tests/golden/kernel_cohort_golden.npz``: the planes of the same call
  with each lane packed by the loaders' chain (K1a's plain version on the
  CPU, one torch thread).
* Under a ``torch.profiler`` session, ``cohort.prepare`` counts
  ``table_builds`` 1 on the call that builds the device's table and 0
  after, and ``lanes`` 128 a call of the 30.

Nothing here imports JAX, so on the card the file runs without the
suite's JAX set-up::

    python -m pytest tests/test_torch_cohort_table.py -q -p no:cacheprovider --noconftest -o addopts=""
"""
import os
from datetime import timedelta

import numpy as np
import pytest
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops.rollout import LANES, pack_params
from simglucose_tpu_torch.sim import engine
from simglucose_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "kernel_cohort_golden.npz")
# names and ids 1-30 (numpy's too), some patients twice
MIXED = [*tables.patient_names()[:10], *range(11, 21), np.int64(30), "child#010", 1, 2,
         *tables.patient_names()[20:][::-1], "adult#005", 15, *range(26, 30), "adolescent#001"]
GOLDEN_RUN = dict(sim_time=timedelta(hours=2), scenario_seed=11, cgm_seed=12)
DP4 = tables.cohort_names(16384)

# (cohort, lane0, lanes): the lanes one rank packs
COHORTS = {
    "ref30": (tables.patient_names(), 0, LANES),
    **{f"dp4_rank{r}": (DP4, r * 4096, 4096) for r in range(4)},
    "mixed": (MIXED, 0, LANES),
    "reversed": (tables.patient_names()[::-1], 0, LANES),
}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]


def _loaders_chain(names, device):
    patient = tables.load_patient_params(names, device=device)
    quest = tables.load_quest_params(names, device=device)
    return pack_params(patient, basal_rate(patient), quest=quest)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cohort", list(COHORTS))
def test_table_lanes_equal_the_loaders_chain(cohort, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names, lane0, per = COHORTS[cohort]
    table, index = engine.patient_table(device)
    got = engine._pack_lanes(table, engine._patient_rows(names, index), lane0, per)
    want = _loaders_chain([names[i % len(names)] for i in range(lane0, lane0 + per)], device)
    assert got.shape == want.shape == (want.shape[0], per // LANES, LANES)
    assert got.dtype == torch.float32 and got.device == want.device
    assert torch.equal(got, want)


def test_simulate_cohort_equals_the_golden():
    res = engine.simulate_cohort(patient_names=MIXED, device="cpu", **GOLDEN_RUN)
    with np.load(GOLDEN) as g:
        for f, v in zip(res.traj._fields, res.traj):
            np.testing.assert_array_equal(v, g[f], err_msg=f)
        for f, v in zip(res.reset._fields, res.reset):
            np.testing.assert_array_equal(v, g[f"reset_{f}"], err_msg=f"reset {f}")
        np.testing.assert_array_equal(res.reward, g["reward"])
    assert res.traj.BG.shape == (40, len(MIXED))


def test_prepare_counts_the_table_build_once(monkeypatch):
    monkeypatch.setattr(engine, "_PATIENT_TABLES", {})
    tprof.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for seed in (1, 2):
                engine.simulate_cohort(sim_time=timedelta(hours=1), scenario_seed=seed,
                                       device="cpu")
        counts = [s.counts for s in tprof.spans() if s.name == "cohort.prepare"]
    finally:
        tprof.clear_spans()
    assert counts == [{"table_builds": 1, "lanes": LANES}, {"table_builds": 0, "lanes": LANES}]
    assert list(engine._PATIENT_TABLES) == [torch.device("cpu")]


@pytest.mark.parametrize("name,error", [("nobody#000", KeyError), (31, ValueError),
                                        (0, ValueError)])
def test_unknown_patients_raise_the_loaders_error(name, error):
    with pytest.raises(error) as got:
        engine.simulate_cohort(sim_time=timedelta(hours=1),
                               patient_names=["adult#001", name], device="cpu")
    with pytest.raises(error) as loaders:
        tables.load_patient_params(["adult#001", name], device="cpu")
    assert str(got.value) == str(loaders.value)
