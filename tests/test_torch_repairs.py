"""The port stands alone and runs on the card unless asked otherwise: it
imports nothing of the JAX package (nor jax, optax, pandas, matplotlib or
gymnasium when its modules load), keeps its own parameter tables (the JAX package's
bytes) and its own analysis report (the JAX package's CSVs), and every
public function (and public class) of it that takes ``device`` defaults to
``"cuda"``, which raises where CUDA is absent."""
import ast
import filecmp
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
from collections import namedtuple
from datetime import datetime

import numpy as np
import pytest
import torch

import simglucose_tpu_torch
from simglucose_tpu import params as jtables
from simglucose_tpu.analysis import report as jreport
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.analysis import report as treport
from simglucose_tpu_torch.controllers.functional import constant_controller, pid_controller
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.envs import T1DSimGymEnv, T1DSimVectorEnv
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.ops.philox import philox_words
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.rl import evaluate as tev
from simglucose_tpu_torch.rl import policy as tpol
from simglucose_tpu_torch.rl import ppo as tppo
from simglucose_tpu_torch.sim.engine import simulate_cohort

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(simglucose_tpu_torch.__path__,
                                                         "simglucose_tpu_torch."))


def test_every_port_module_imports_nothing_of_the_jax_package():
    """In a fresh interpreter (this one has jax loaded by conftest): every
    module of the port loads without any ``simglucose_tpu`` module, jax,
    optax, pandas, matplotlib or gymnasium (which the card's machine does
    not have)."""
    mods = _port_modules()
    assert {"simglucose_tpu_torch.rl.ppo", "simglucose_tpu_torch.rl.fused",
            "simglucose_tpu_torch.ops.ppo_learner",
            "simglucose_tpu_torch.analysis.report", "simglucose_tpu_torch.rl.evaluate",
            "simglucose_tpu_torch.ops.roofline",
            "simglucose_tpu_torch.tools.roofline_rollout",
            # the bench
            "simglucose_tpu_torch.tools.bench", "simglucose_tpu_torch.tools.bench_pallas",
            # the eager env path
            "simglucose_tpu_torch.compat.noise", "simglucose_tpu_torch.compat.scenario",
            "simglucose_tpu_torch.controllers.functional", "simglucose_tpu_torch.devices.cgm",
            "simglucose_tpu_torch.devices.pump", "simglucose_tpu_torch.envs.build",
            "simglucose_tpu_torch.envs.functional", "simglucose_tpu_torch.envs.rollout",
            "simglucose_tpu_torch.models.patient", "simglucose_tpu_torch.ops.noise",
            "simglucose_tpu_torch.ops.streams", "simglucose_tpu_torch.scenario.meal",
            # the user API
            "simglucose_tpu_torch.sim", "simglucose_tpu_torch.utils",
            "simglucose_tpu_torch.utils.checkpoint", "simglucose_tpu_torch.envs",
            "simglucose_tpu_torch.envs.gym_env", "simglucose_tpu_torch.envs.rllab_compat",
            "simglucose_tpu_torch.compat.seeding", "simglucose_tpu_torch.compat.patient",
            # multi-device
            "simglucose_tpu_torch.parallel", "simglucose_tpu_torch.parallel.multihost",
            "simglucose_tpu_torch.parallel.sharding",
            "simglucose_tpu_torch.parallel.dryrun"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'simglucose_tpu' "
        "or m.startswith('simglucose_tpu.') "
        "or m.split('.')[0] in ('jax', 'optax', 'pandas', 'matplotlib', 'gymnasium')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_port_names_the_jax_package():
    """No import statement anywhere in the port's sources or chip_smoke.py
    (function bodies included) names the JAX package or jax."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.dirname(simglucose_tpu_torch.__file__)):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("simglucose_tpu", "jax", "optax"), f"{path} imports {name}"


def _public_functions_with_device():
    """Public functions, and the ``__init__`` of public classes, whose
    ``device`` is optional (``check_device``, which resolves one, takes it
    as given).  A module's names are its globals and its ``__all__`` (the
    Gym adapters are built at first use)."""
    for m in _port_modules():
        mod = importlib.import_module(m)
        names = dict.fromkeys([*vars(mod), *getattr(mod, "__all__", ())])
        for name in names:
            obj = getattr(mod, name)
            if name.startswith("_") or getattr(obj, "__module__", None) != m:
                continue
            if inspect.isclass(obj):
                fn = obj.__init__
            elif inspect.isfunction(obj):
                fn = obj
            else:
                continue
            param = inspect.signature(fn).parameters.get("device")
            if param is not None and param.default is not inspect.Parameter.empty:
                yield f"{m}.{name}", fn


def test_device_parameters_default_to_cuda():
    found = dict(_public_functions_with_device())
    assert {"simglucose_tpu_torch.rl.policy.init_policy",
            "simglucose_tpu_torch.rl.ppo.opt_state_from_optax",
            "simglucose_tpu_torch.params.load_patient_params",
            "simglucose_tpu_torch.core.types.from_jax",
            "simglucose_tpu_torch.sim.engine.simulate_cohort",
            "simglucose_tpu_torch.rl.evaluate.evaluate_controller",
            "simglucose_tpu_torch.rl.evaluate.evaluate_policy_kernel",
            "simglucose_tpu_torch.envs.build.make_env",
            "simglucose_tpu_torch.ops.streams.env_keys",
            "simglucose_tpu_torch.controllers.functional.pid_controller",
            "simglucose_tpu_torch.controllers.functional.constant_controller",
            "simglucose_tpu_torch.sim.engine.SimObj",
            "simglucose_tpu_torch.envs.gym_env.T1DSimGymEnv",
            "simglucose_tpu_torch.envs.gym_env.T1DSimVectorEnv"} <= set(found)
    for name, fn in found.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda", name


_AdamLike = namedtuple("_AdamLike", "count mu nu")


def _entry_calls():
    arrays = [np.zeros(s, np.float32) for s in ((7, 4), (4,), (4, 4), (4,), (4, 1), (1,), (1,),
                                                 (4, 1), (1,))]
    ckpt = os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_relu64.npz")
    return {
        "load_patient_params": lambda **kw: tables.load_patient_params("adult#001", **kw).BW,
        "load_quest_params": lambda **kw: tables.load_quest_params("adult#001", **kw).CR,
        "load_sensor_params": lambda **kw: tables.load_sensor_params("Dexcom", **kw)[0],
        "load_pump_params": lambda **kw: tables.load_pump_params("Insulet", **kw)[0],
        "init_policy": lambda **kw: tpol.init_policy(torch.Generator(), hidden=4, **kw).w1,
        "policy_from_numpy": lambda **kw: tpol.policy_from_numpy(arrays, **kw).w1,
        "load_policy_npz": lambda **kw: tpol.load_policy_npz(ckpt, act="relu", **kw).w1,
        "opt_state_from_optax": lambda **kw: tppo.opt_state_from_optax(
            _AdamLike(3, np.zeros(5, np.float32), np.zeros(5, np.float32)), **kw).mu,
        "from_jax": lambda **kw: from_jax(jtables.load_quest_params("adult#001"), **kw).CR,
        "philox_words": lambda **kw: philox_words(8, (1, 2), 0, 0, **kw),
        "make_env": lambda **kw: make_env("adult#001", **kw)[1].patient.BW,
        "env_keys": lambda **kw: env_keys(1, 4, **kw),
        "pid_controller": lambda **kw: pid_controller(3, **kw)[0].prev,
        "constant_controller": lambda **kw: constant_controller(0.01, **kw)[1]((), None)[1].basal,
        "T1DSimGymEnv": lambda **kw: T1DSimGymEnv(seed=0, **kw)._state.patient.x,
        "T1DSimVectorEnv": lambda **kw: T1DSimVectorEnv(2, **kw)._params.patient.BW,
    }


@pytest.mark.parametrize("name", sorted(_entry_calls()))
def test_entry_point_runs_on_the_card_unless_asked(name):
    """Called without ``device`` the result lies on the card, or, where
    there is none, the call raises; ``device="cpu"`` runs on the CPU."""
    call = _entry_calls()[name]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_evaluations_run_on_the_card_unless_asked():
    """The evaluation entry points return numpy planes: on the CPU when
    asked, and without ``device`` they raise where there is no card."""
    arrays = [np.zeros(s, np.float32) for s in ((7, 8), (8,), (8, 8), (8,), (8, 1), (1,), (1,),
                                                 (8, 1), (1,))]
    calls = {
        "evaluate_controller": lambda **kw: tev.evaluate_controller(
            "BB", ["adult#001"], hours=0.1, **kw),
        "evaluate_policy_kernel": lambda **kw: tev.evaluate_policy_kernel(
            tpol.policy_from_numpy(arrays, act="relu", device="cpu"), ["adult#001"], hours=0.1,
            **kw),
    }
    for name, call in calls.items():
        assert call(device="cpu")["BG"].shape == (1, 2), name
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_simulate_cohort_raises_without_a_card_by_default(engine):
    """On either engine: the rollout kernel and the eager env path."""
    if torch.cuda.is_available():
        assert inspect.signature(simulate_cohort).parameters["device"].default == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulate_cohort(patient_names=["adult#001"], engine=engine)


def test_parameter_tables_are_the_jax_packages_bytes():
    jdir = os.path.join(ROOT, "simglucose_tpu", "params", "data")
    names = sorted(os.listdir(jdir))
    assert names == ["pump.json", "quest.json", "sensor.json", "vpatient.json"]
    assert sorted(os.listdir(tables._DATA_DIR)) == names
    for n in names:
        assert filecmp.cmp(os.path.join(jdir, n), os.path.join(tables._DATA_DIR, n),
                           shallow=False), n


_Row = namedtuple("_Row", "BG CGM CHO insulin LBGI HBGI risk")


def test_report_writes_the_jax_packages_csvs(tmp_path):
    """The port's report and the JAX package's, on one seeded two-day
    frame of four patients (glucose from 30 to 420 mg/dL, so every zone is
    visited), write the same three CSVs, byte for byte."""
    rng = np.random.default_rng(0)
    T, B = 960, 4
    bg = np.clip(150 + np.cumsum(rng.normal(0, 6, (T, B)), axis=0), 30, 420)
    fields = lambda x, n: _Row(x, x + rng.normal(0, 5, n), rng.uniform(0, 1, n),
                               rng.uniform(0, 0.05, n), rng.uniform(0, 5, n),
                               rng.uniform(0, 5, n), rng.uniform(0, 10, n))
    reset = fields(bg[0], B)
    traj = fields(bg, (T, B))
    names = [f"patient#{i:03d}" for i in range(B)]
    df = treport.cohort_frame(reset, traj, names, datetime(2018, 1, 1), 3)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jreport.report(df, save_path=str(tmp_path / "jax"))
    treport.report(df, save_path=str(tmp_path / "port"))
    for csv in ("performance_stats.csv", "risk_trace.csv", "CVGA_stats.csv"):
        assert filecmp.cmp(tmp_path / "jax" / csv, tmp_path / "port" / csv, shallow=False), csv
