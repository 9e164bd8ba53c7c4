"""The port's wizard (``simglucose_tpu_torch/sim/user_interface.py``)
against the JAX package's: the same scripted answers (tests/test_sim_api.py
::test_interactive_ui_wizard's, and a second script through the other
menus: a group of patients, a custom scenario with a snack, PID, a save
path, animation) go into both wizards with their ``simulate`` replaced by a
recorder.  Each wizard must ask the same prompts in the same order and
pass the same arguments (patients, sensor, seed, pump, scenario, start
time, sim time, controller, save path, animate, parallel).  One last run
goes through the port's real ``simulate`` on the CPU."""
from datetime import datetime, timedelta
from unittest import mock

import pytest
import torch

from simglucose_tpu.sim import user_interface as jui
from simglucose_tpu_torch.sim import user_interface as tui

torch.set_num_threads(1)

SCRIPTS = {
    "by_id": ["n", "y", "", "2", "1", "6", "5", "1", "1", "d", "1", "7", "2", "1"],
    "groups_custom": ["y", "n", "out", "", "x", "2", "7", "45", "12", "60", "18.5", "70",
                      "maybe", "y", "15", "10", "n", "", "4", "abc", "3", "", "1", "2"],
}


def _drive(module, answers, **kw):
    prompts, calls = [], []
    it = iter(answers)

    def answer(prompt=""):
        prompts.append(prompt)
        return next(it)

    with mock.patch("builtins.input", side_effect=answer), \
            mock.patch.object(module, "_simulate", side_effect=lambda **a: calls.append(a)), \
            mock.patch("builtins.print"):
        module.simulate(**kw)
    assert len(calls) == 1 and next(it, None) is None
    return prompts, calls[0]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_wizard_passes_what_the_jax_wizard_passes(script):
    jp, jargs = _drive(jui, SCRIPTS[script])
    tp, targs = _drive(tui, SCRIPTS[script])
    assert tp == jp
    assert targs == jargs
    keys = {"patient_names", "cgm_name", "cgm_seed", "insulin_pump_name", "scenario",
            "start_time", "sim_time", "controller", "save_path", "animate", "parallel"}
    assert keys <= set(targs)


def test_scripts_reach_both_menus():
    _, a = _drive(tui, SCRIPTS["by_id"])
    assert a["patient_names"] == ["adolescent#001"] and a["controller"] == "BB"
    assert a["start_time"] == datetime(2018, 1, 1, 6) and a["sim_time"] == timedelta(hours=2)
    assert (a["cgm_seed"], a["scenario"], a["save_path"], a["animate"]) == (7, None, None, False)
    _, b = _drive(tui, SCRIPTS["groups_custom"])
    assert b["scenario"] == [(7.0, 45.0), (12.0, 60.0), (18.5, 70.0), (15.0, 10.0)]
    assert all(n.startswith("child") for n in b["patient_names"])
    assert (b["controller"], b["save_path"], b["animate"], b["parallel"]) == ("PID", "out",
                                                                             True, False)
    assert b["sim_time"] == timedelta(hours=24) and b["cgm_seed"] == 0


def test_wizard_runs_the_ports_simulate():
    answers = iter(SCRIPTS["by_id"])
    with mock.patch("builtins.input", side_effect=lambda *a: next(answers)):
        df = tui.simulate(device="cpu")
    assert len(df.loc["adolescent#001"]) == 2 * 60 // 3 + 1
