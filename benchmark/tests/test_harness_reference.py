"""The plain reference against the program's CPU path at a tiny size, and
the control: the reference in bfloat16 put in the program's place fails
each cell's limits."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.reference import rollout as ref
from benchmark.reference import tables as ref_tables
from benchmark.tests.conftest import TINY, TINY_CONFIG

torch.set_num_threads(1)


def cell(name: str):
    wl = run.load_json(os.path.join(run.HERE, "workloads", f"{name}.json"))
    conf = run.load_json(os.path.join(run.HERE, "configs", f"{wl['config']}.json"))
    wl = dict(wl, **TINY[name])
    conf = dict(conf, **TINY_CONFIG.get(conf["name"], {}))
    return run.load_module("drivers", wl["entry"]), wl, conf


@pytest.mark.parametrize("controller", ["pid", "bb"])
def test_rollout_matches_the_programs_plain_version(controller):
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import RolloutConfig, pack_params, rollout

    B, T = 128, 40
    names = [ref_tables.patient_names()[i % 30] for i in range(B)]
    patient = tables.load_patient_params(names, device="cpu")
    packed = pack_params(patient, basal_rate(patient),
                         quest=tables.load_quest_params(names, device="cpu"))
    key = (2 ** 32 - 7, 123456789)
    prog = rollout(RolloutConfig(n_steps=T, controller=controller), packed, key)
    want, _ = ref.rollout(ref.Config(n_steps=T, controller=controller),
                          ref_tables.patients(names, "cpu"), key, torch.arange(B))
    for k in ("BG", "CGM", "reward", "insulin", "CHO", "done", "BG0", "CGM0"):
        assert torch.equal(prog[k], want[k]), k


def test_policy_rollout_matches_the_programs_learner_rows():
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.rollout import RolloutConfig, pack_params, pack_policy_weights
    from simglucose_tpu_torch.ops.rollout import rollout
    from simglucose_tpu_torch.rl.policy import PolicyParams

    drv, wl, conf = cell("ppo.fused8192_t64")
    B, T, H = 128, 12, conf["hidden"]
    names = drv.names_of(B)
    patient = tables.load_patient_params(names, device="cpu")
    policy = drv.initial_policy(conf, 77, torch.device("cpu"))
    params = PolicyParams(**policy, act="relu")
    cfg = RolloutConfig(n_steps=T, controller="nn", nn_hidden=H, nn_emit_learner_rows=True)
    prog = rollout(cfg, pack_params(patient, basal_rate(patient)), (5, 6),
                   weights=pack_policy_weights(params))
    want, _ = ref.rollout(ref.Config(n_steps=T, controller="nn"), ref_tables.patients(names, "cpu"),
                          (5, 6), torch.arange(B), policy=policy)
    rows = prog["learner"].view(10, T, B)
    assert torch.allclose(rows[:7].permute(1, 2, 0), want["obs"], atol=1e-6)
    for i, k in ((7, "value"), (8, "raw"), (9, "logp")):
        assert torch.allclose(rows[i], want[k], rtol=1e-5, atol=1e-5), k
    assert torch.allclose(prog["BG"], want["BG"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_fails_the_cells_limits(name):
    drv, wl, conf = cell(name)
    numbers = (drv.control(conf, wl, 2 ** 35 + 3, "cpu") if name.startswith("ppo")
               else drv.control(conf, wl, 2 ** 35 + 3))
    assert any(v > wl["limits"][k] for k, v in numbers.items()), numbers


def test_a_planted_half_batch_fails_the_training_limits():
    drv, wl, conf = cell("ppo.fused8192_t64")
    numbers = drv.fault(conf, wl, 2 ** 35 + 3, "cpu")
    assert any(v > wl["limits"][k] for k, v in numbers.items()), numbers


def test_window_calls_followed_from_the_programs_state(tiny_tree):
    """The reference follows sampled window calls of the fused cell from
    the state each started from: the program's calls agree with it, and
    the control and a planted half batch put in the program's place at
    those calls fail the window's limits."""
    src = "\n".join([
        "import sys, json", f"sys.path.insert(0, {tiny_tree!r})", "import torch",
        "from benchmark import run",
        "seen = {}",
        "def hook(r):",
        "    seen.update(look=r.window_look(), control=r.window_readings('control'),",
        "                half=r.window_readings('half_batch'), limits=r.limits)",
        "res = run.run_cell('ppo.fused8192_t64', 2 ** 40 + 9, 1.0, device='cpu',",
        "                   look_for_cards=False, after_check=hook)",
        "print(json.dumps(dict(seen, checks=res['checks'])))"])
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          timeout=300, cwd=tiny_tree, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    window = {k: v["value"] for k, v in out["checks"].items() if k.startswith("window_")}
    assert set(window) == {"window_loss_gap", "window_moment_gap", "window_update_gap"}
    assert max(window.values()) < 1e-4, window
    assert len(out["look"]) == 2 and all(c["lanes_reset_apart"] == 0 for c in out["look"])
    for kind in ("control", "half"):
        assert any(v > out["limits"][k] for k, v in out[kind].items()), (kind, out[kind])


def test_the_config_files_are_what_the_reference_reads():
    with open(os.path.join(run.HERE, "configs", "cohort.json")) as f:
        conf = json.load(f)
    fields = ref.sensor_pump(ref_tables.by_name("sensor")[conf["sensor"]],
                             ref_tables.by_name("pump")[conf["pump"]])
    assert fields["sample_time"] == conf["sample_time"] == 3
