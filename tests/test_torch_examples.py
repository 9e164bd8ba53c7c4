"""The port's examples (``simglucose_tpu_torch/examples/``), one case each,
and the patient demo (``models/patient.py::_demo``): each ``main`` runs
through at a small size on the CPU, and what it returns and prints has the
columns, keys and lines that the JAX example's code prints (read from the
JAX scripts, not by running them; the JAX scripts run their sizes at
import).  The committed checkpoints and the canned results stay as they
are."""
import glob
import os
import re
from unittest import mock

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from simglucose_tpu_torch.examples import (  # noqa: E402
    advanced_tutorial,
    apply_customized_controller,
    custom_reward_function,
    eval_ppo,
    fast_cohort_sim,
    offline_analysis,
    run_gym,
    run_pid_controller,
    run_user_interface,
    train_ppo,
    train_ppo_fused,
)
from simglucose_tpu_torch.models import patient as tpatient  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ["BG", "CGM", "CHO", "insulin", "LBGI", "HBGI", "Risk"]
CPU = dict(device="cpu")


def _files(*parts):
    return {p: (os.stat(p).st_mtime_ns, open(p, "rb").read())
            for p in sorted(glob.glob(os.path.join(ROOT, *parts, "*")))}


def check_advanced_tutorial(tmp_path, out):
    df, results = advanced_tutorial.main(save_path=str(tmp_path / "results"), hours=2, **CPU)
    assert list(df.columns) == COLUMNS
    assert list(df.index.levels[0]) == ["adolescent#001", "adolescent#002", "adult#001"]
    assert [list(r.columns) for r in results] == [COLUMNS, COLUMNS]
    assert os.path.exists(tmp_path / "results" / "performance_stats.csv")
    text = out()
    assert all(k in text for k in ("count", "mean", "std", "max"))


def check_apply_customized_controller(tmp_path, out):
    df = apply_customized_controller.main(hours=1, **CPU)
    assert list(df.columns) == COLUMNS and df.loc["adolescent#001"].index[0].hour == 6
    assert "Name: BG" in out()


def check_custom_reward_function(tmp_path, out):
    rewards = custom_reward_function.main(steps=6, **CPU)
    assert len(rewards) == 6 and set(rewards) <= {1.0, -1.0, -2.0}
    assert re.search(r"^t=0 CGM= *[\d.]+ reward=[+-]\d\.\d$", out(), re.M)


def check_eval_ppo(tmp_path, out):
    before = _files("examples", "checkpoints")
    summaries = eval_ppo.main(hours=1.0, seed=3, **CPU)
    assert list(summaries) == ["PPO residual-BB", "PPO (absolute)", "BB therapy", "PID"]
    for df in summaries.values():
        assert len(df) == 30
        assert {"risk_index", "LBGI", "HBGI", "percent_in_70_180", "percent_below_70",
                "BG_mean"} <= set(df.columns)
    text = out()
    assert "=== Cohort means ===" in text and "PPO residual-BB mean risk index" in text
    assert _files("examples", "checkpoints") == before


def check_fast_cohort_sim(tmp_path, out):
    got = fast_cohort_sim.main(n_patients=64, hours=2, **CPU)
    assert got["samples"] == 64 * 40
    assert re.search(r"^cohort: 2560 samples; BG mean [\d.]+ mg/dL; time-in-\[70,180\] "
                     r"[\d.]+%$", out(), re.M)


def check_offline_analysis(tmp_path, out):
    before = _files("examples", "results", "canned")
    results = offline_analysis.main(save_path=str(tmp_path))
    assert len(results) == 5 and "Risk Index" in results.columns
    assert os.path.exists(tmp_path / "performance_stats.csv")
    assert _files("examples", "results", "canned") == before


def check_run_gym(tmp_path, out):
    from gymnasium.envs.registration import registry

    before = dict(registry)
    try:
        seen = run_gym.main(steps=5, **CPU)
    finally:
        registry.clear()
        registry.update(before)
    assert len(seen) == 5 and np.isfinite(seen).all()
    assert re.search(r"^t=4 CGM= *[\d.]+ reward=[+-][\d.]+ BG=[\d.]+$", out(), re.M)


def check_run_pid_controller(tmp_path, out):
    df = run_pid_controller.main(hours=2, **CPU)
    assert list(df.columns) == COLUMNS
    assert re.search(r"^\s+BG\s+CGM\s+insulin$", out(), re.M)


def check_run_user_interface(tmp_path, out):
    answers = iter(["n", "y", "", "1", "1", "", "5", "3", "d", "1", "", "2", "2"])
    with mock.patch("builtins.input", side_effect=lambda *a: next(answers)):
        df = run_user_interface.main(**CPU)
    assert list(df.columns) == COLUMNS and len(df) == 60 // 3 + 1


def check_train_ppo(tmp_path, out):
    history = train_ppo.main(batch=16, iters=2, rollout_steps=4, **CPU)
    assert len(history) == 2
    assert {"reward_mean", "done_frac", "pg_loss", "v_loss"} <= set(history[0])
    assert re.search(r"^iter   1  reward=[+-][\d.]+  done%=[\d.]+  pg=[+-][\d.]+  v=[\d.]+$",
                     out(), re.M)


def check_train_ppo_fused(tmp_path, out):
    history = train_ppo_fused.main(batch=128, blocks=2, iters_per_block=1, rollout_steps=8,
                                   hidden=16, **CPU)
    assert len(history) == 2 and {"reward_mean", "done_frac", "entropy"} <= set(history[0])
    assert re.search(r"^iter    2  reward [+-][\d.]+  done/step [\d.]+  entropy [\d.]+$", out(),
                     re.M)


def check_patient_demo(tmp_path, out):
    bg = tpatient._demo(minutes=160, **CPU)
    assert bg.shape == (160,) and np.isfinite(bg).all()
    assert bg[0] == pytest.approx(149.02, abs=0.01)
    assert re.search(r"^BG: start=[\d.]+ peak=[\d.]+ end=[\d.]+ mg/dL$", out(), re.M)


CASES = {name[len("check_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("check_")}


def test_every_jax_example_has_a_case():
    jax_examples = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(ROOT, "examples",
                                                                             "*.py"))}
    assert jax_examples == set(CASES) - {"patient_demo"}
    assert len(jax_examples) == 11


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs(name, tmp_path, capsys):
    CASES[name](tmp_path, lambda: capsys.readouterr().out)
