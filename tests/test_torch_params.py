"""Port package surface vs the JAX package: no jax on import, the parameter
loaders, the rollout's packed parameter planes and its config checks."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from simglucose_tpu import params as jtables
from simglucose_tpu.models.uva_padova import basal_rate as jax_basal_rate
from simglucose_tpu.ops import pallas_rollout as jpr
from simglucose_tpu_torch import params as ttables
from simglucose_tpu_torch.core.types import PatientParams, QuestParams, from_jax
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr

torch.set_num_threads(1)

SLICE_MODULES = [
    "simglucose_tpu_torch",
    "simglucose_tpu_torch.params",
    "simglucose_tpu_torch.core.types",
    "simglucose_tpu_torch.models.uva_padova",
    "simglucose_tpu_torch.analysis.risk",
    "simglucose_tpu_torch.analysis.report",
    "simglucose_tpu_torch.ops.philox",
    "simglucose_tpu_torch.ops.rollout",
    "simglucose_tpu_torch.ops.build",
    "simglucose_tpu_torch.envs.functional",
    "simglucose_tpu_torch.scenario.meal",
    "simglucose_tpu_torch.sim.engine",
]


def test_import_leaves_out_jax_pandas_matplotlib():
    """In a fresh interpreter (this one has jax loaded by conftest):
    importing the package and every module of the slice pulls in neither
    jax nor pandas nor matplotlib, which the GPU machine does not have."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'pandas', 'matplotlib') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loaders_match_jax(dtype):
    """All 30 patients, by name and by ID, equal the JAX loader's values
    exactly; so do the Quest, sensor and pump records."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    names = ttables.patient_names()
    assert names == jtables.patient_names() and len(names) == 30
    assert ttables.sensor_names() == jtables.sensor_names()
    assert ttables.pump_names() == jtables.pump_names()
    for sel in (names, list(range(1, 31))):
        got = ttables.load_patient_params(sel, dtype=tdt, device="cpu")
        ref = jtables.load_patient_params(sel, dtype=dtype)
        for f in PatientParams._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    got = ttables.load_quest_params(names, dtype=tdt, device="cpu")
    ref = jtables.load_quest_params(names, dtype=dtype)
    for f in QuestParams._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for s in ttables.sensor_names():
        assert ttables.sensor_record(s) == jtables.sensor_record(s)
        assert ttables.sensor_sample_time(s) == jtables.sensor_sample_time(s)
        for g, r in zip(ttables.load_sensor_params(s, dtype=tdt, device="cpu"), jtables.load_sensor_params(s, dtype=dtype)):
            assert g.item() == float(r)
    for p in ttables.pump_names():
        assert ttables.pump_record(p) == jtables.pump_record(p)
        for g, r in zip(ttables.load_pump_params(p, dtype=tdt, device="cpu"), jtables.load_pump_params(p, dtype=dtype)):
            assert g.item() == float(r)


def test_name_resolution_and_fallbacks():
    """IDs resolve like names; an unknown patient raises KeyError, a bad ID
    ValueError; an unknown name gets the 'Average' Quest record."""
    assert ttables._resolve_names(1) == ["adolescent#001"] == jtables._resolve_names(1)
    assert ttables._resolve_names([30, "adult#002"]) == jtables._resolve_names([30, "adult#002"])
    with pytest.raises(KeyError, match="unknown patient"):
        ttables.load_patient_params("nobody#999", device="cpu")
    with pytest.raises(ValueError, match="patient id"):
        ttables.load_patient_params(31, device="cpu")
    q = ttables.load_quest_params(["nobody#999", "adult#001"], dtype=torch.float64, device="cpu")
    ref = jtables.load_quest_params(["nobody#999", "adult#001"], dtype=np.float64)
    assert q.CR[0].item() == 1 / 15 and q.CF[0].item() == 1 / 50
    for f in QuestParams._fields:
        np.testing.assert_array_equal(getattr(q, f).numpy(), np.asarray(getattr(ref, f)))
    assert ttables.AVERAGE_QUEST == jtables.AVERAGE_QUEST
    assert ttables.cohort_names(65)[30:33] == ttables.patient_names()[:3]


@pytest.mark.parametrize("with_quest", [True, False])
def test_pack_params_bit_equal(with_quest):
    """The packed [50, rows, 128] planes equal the JAX package's bit for
    bit, the finite -1.0 Quest sentinel included; packed_basal reads the
    basal plane back."""
    names = ttables.cohort_names(256)
    jp = jtables.load_patient_params(names, dtype=np.float32)
    jq = jtables.load_quest_params(names, dtype=np.float32) if with_quest else None
    ref = np.asarray(jpr.pack_params(jp, jax_basal_rate(jp), quest=jq))
    tp = from_jax(jp, device="cpu")
    got = tr.pack_params(tp, basal_rate(tp), quest=None if jq is None else from_jax(jq, device="cpu"))
    assert got.shape == ref.shape == (tr.NP_PLANES, 2, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    if not with_quest:
        assert (got[-2:] == -1.0).all()
    np.testing.assert_array_equal(tr.packed_basal(got).numpy(), np.asarray(jpr.packed_basal(ref)))
    p100 = from_jax(jtables.load_patient_params(names[:100]), device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        tr.pack_params(p100, basal_rate(p100))


@pytest.mark.parametrize("sensor", ["Dexcom", "GuardianRT", "Navigator"])
def test_config_for_sensor_matches_jax(sensor):
    got = tr.config_for_sensor(sensor, controller="bb")
    ref = jpr.config_for_sensor(sensor, controller="bb")
    for f in tr.RolloutConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(ref, f), f


def test_from_jax_keeps_dtype_and_rejects_unknown():
    jp = jtables.load_patient_params(["adult#001"], dtype=np.float64)
    tp = from_jax(jp, device="cpu")
    assert tp.x0.shape == (1, 13) and tp.BW.dtype == torch.float64
    with pytest.raises(TypeError):
        from_jax(object(), device="cpu")


@pytest.mark.parametrize(
    "fields,match",
    [
        (dict(exogenous_noise=True, autoreset=True), "exogenous_noise requires autoreset=False"),
        (dict(scenario_kind="weekly"), "scenario_kind must be"),
        (dict(det_meal_times=(1, 2), det_meal_amounts=(3.0,)), "same length"),
        (dict(reward_kind="tir"), "reward_kind must be"),
        (dict(controller="mpc"), "controller must be one of"),
    ],
)
def test_rollout_config_rejected_like_jax(fields, match):
    """The JAX wrapper's ValueErrors for the fields the port keeps."""
    p = ttables.load_patient_params(ttables.cohort_names(128), device="cpu")
    with pytest.raises(ValueError, match=match):
        tr.rollout(tr.RolloutConfig(n_steps=2, **fields), tr.pack_params(p, basal_rate(p)))


def test_nn_controller_is_not_ported_yet():
    """The 'nn' controller (K1b) is ported now: without policy weights it
    refuses to run, and names where they come from."""
    p = ttables.load_patient_params(ttables.cohort_names(128), device="cpu")
    with pytest.raises(ValueError, match="pack_policy_weights"):
        tr.rollout(tr.RolloutConfig(n_steps=2, controller="nn"), tr.pack_params(p, basal_rate(p)))
