"""The port's trainer CLI (``simglucose_tpu_torch/tools/train_ppo.py``)
against the JAX package's ``tools/train_ppo_tpu.py``.

* ``hypo_weighted_reward``: the JAX tool defines it inside ``main``; its
  source is taken from the file with ``ast`` and run on JAX's
  ``risk_scalar``, and both rewards take the same seeded float32 CGM
  planes (39-600 mg/dL, both sides of the 90 mg/dL barrier and of the 400
  clip): rtol 1e-6, and atol 1e-5 where the reward is near 0: in float32,
  fBG cancels near BG 112.5 (ln(BG)^1.084 - 5.381) and torch and XLA round
  pow an ulp apart there (tests/test_torch_physics.py::test_risk_matches_jax
  holds risk to the same floor).
* ``main`` at a small size on the CPU (the kernels' plain versions): B=128
  (the kernel path's smallest cohort: one 128-lane row), H=16, T=8, one
  block of one iteration, 2 h evaluations, ``PPO_CKPT`` under the test's
  temporary directory.  The checkpoint restores into a policy that differs
  from the initial one, the summary has the JAX tool's keys, and no file
  under ``examples/checkpoints/`` changes (bytes and mtimes; none added).
"""
import ast
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.analysis.risk import risk_scalar as jrisk_scalar
from simglucose_tpu_torch.rl.ppo import flatten_params
from simglucose_tpu_torch.tools import train_ppo
from simglucose_tpu_torch.utils.checkpoint import restore_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "train_ppo_tpu.py")
JAX_KEYS = {"iters", "env_steps", "wall_s", "ri_start", "ri_best", "ckpt"}


def _jax_reward(hypo_w, barrier_w, rew_scale):
    """The JAX tool's ``hypo_weighted_reward`` closure, from its source."""
    tree = ast.parse(open(JAX_TOOL).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "hypo_weighted_reward")
    ns = dict(jnp=jnp, risk_scalar=jrisk_scalar, hypo_w=hypo_w, barrier_w=barrier_w,
              rew_scale=rew_scale)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), JAX_TOOL, "exec"), ns)
    return ns["hypo_weighted_reward"]


@pytest.mark.parametrize("weights", [(3.0, 0.15, 1.0), (1.5, 0.4, 0.25)])
def test_hypo_weighted_reward_matches_jax(weights):
    cgm = np.random.default_rng(5).uniform(39.0, 600.0, (16, 256)).astype(np.float32)
    cgm[0, :4] = (39.0, 90.0, 112.5, 600.0)
    want = np.asarray(_jax_reward(*weights)({"CGM": jnp.asarray(cgm)}))
    got = train_ppo.make_hypo_weighted_reward(*weights)({"CGM": torch.from_numpy(cgm)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def _committed_checkpoints():
    return {p: (os.stat(p).st_mtime_ns, open(p, "rb").read())
            for p in sorted(glob.glob(os.path.join(ROOT, "examples", "checkpoints", "*")))}


def test_main_trains_and_keeps_a_checkpoint(tmp_path, monkeypatch, capsys):
    before = _committed_checkpoints()
    ckpt = tmp_path / "best.npz"
    monkeypatch.setenv("PPO_CKPT", str(ckpt))
    out = train_ppo.main(["1", "1"], batch=128, hidden=16, rollout_steps=8, eval_hours=2.0,
                         device="cpu")
    assert JAX_KEYS <= set(out) and out["ckpt"] == str(ckpt)
    assert out["iters"] == 1 and out["env_steps"] == 128 * 8
    assert np.isfinite([out[k] for k in ("ri_start", "ri_best", "train_ms_per_iter",
                                         "eval_s")]).all()
    printed = capsys.readouterr().out
    assert "BB baseline (seed 999)" in printed and "<- checkpoint" in printed
    fresh = train_ppo.initial_policy(train_ppo.ppo_config(8), 16, device="cpu")
    best = restore_state(str(ckpt), like=fresh)
    assert (best.act, best.decoder, best.action_scale) == ("relu", "sigmoid", 10.0)
    assert not torch.equal(flatten_params(best), flatten_params(fresh))
    assert _committed_checkpoints() == before


def test_default_checkpoint_is_not_a_committed_file():
    rel = os.path.relpath(train_ppo.DEFAULT_CKPT, ROOT)
    assert rel == os.path.join("examples", "checkpoints", "ppo_cohort_relu64_torch.npz")
    assert rel not in _committed_checkpoints()
    assert rel in open(os.path.join(ROOT, ".gitignore")).read().split()
