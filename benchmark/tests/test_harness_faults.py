"""Runs of each cell on the CPU with the timed path broken underneath:
the harness's look for a card is skipped, the rest of a run is driven,
and ``correct`` has to come out false, once for each fault the cell can
have: a step that returns its state unchanged, half of the batch left
out, the exchange between ranks left out, an answer altered where it is
produced.  Unbroken, the same runs are correct."""
from __future__ import annotations

import pytest

from benchmark.tests.conftest import drive

# every call returns the first call's trajectory (``M``: the module whose
# ``rollout`` the entry calls)
STALE = """
orig = M.rollout
memo = []
def broken(*a, **k):
    memo.append(memo[0] if memo else orig(*a, **k))
    return memo[-1]
M.rollout = broken
"""


def altered(plane: str, expr: str) -> str:
    """The rollout's ``plane`` replaced by ``expr`` of itself (``x``)."""
    return f"""
orig = M.rollout
def broken(*a, **k):
    out = orig(*a, **k)
    x = out[{plane!r}]
    out[{plane!r}] = {expr}
    return out
M.rollout = broken
"""


ROLLOUT = "import simglucose_tpu_torch.ops.rollout as M\n"
ENGINE = "import simglucose_tpu_torch.sim.engine as M\n"
FUSED = "import simglucose_tpu_torch.rl.fused as M\n"
# half of the patients carry the other half's BG in the engine's result
HALF_PATIENTS = ENGINE + """
orig = M.simulate_cohort
def broken(*a, **k):
    res = orig(*a, **k)
    bg = res.traj.BG.copy()
    h = bg.shape[1] // 2
    bg[:, h:2 * h] = bg[:, :h]
    return res._replace(traj=res.traj._replace(BG=bg))
M.simulate_cohort = broken
"""
FAULTS = {
    "cohort.pid4096_1d": {
        "state_unchanged": ROLLOUT + STALE,
        # the second half of the lanes carries the first half's results
        "half_batch": ROLLOUT + altered(
            "BG", "torch.cat([x[:, :x.shape[1] // 2]] * 2, 1)"),
        "answer_altered": ROLLOUT + altered("BG", "x * 1.01"),
    },
    "cohort.ref30_1d": {
        "state_unchanged": ENGINE + STALE,
        "half_batch": HALF_PATIENTS,
        "answer_altered": ENGINE + altered("CGM", "x + 1.0"),
    },
    "ppo.fused8192_t64": {
        # the update is computed and dropped: params and optimizer state stay
        "state_unchanged": FUSED + """
orig = M._update_packed
def broken(cfg, opt, params, opt_state, *a, **k):
    return params, opt_state, orig(cfg, opt, params, opt_state, *a, **k)[2]
M._update_packed = broken
""",
        # each grad step over half of its minibatch's blocks, the mean over those
        "half_batch": """
import simglucose_tpu_torch.ops.ppo_learner as M
orig = M.ppo_grad_step_gather2
def broken(main, advret, perm_mb, *a, **k):
    return orig(main, advret, perm_mb[: perm_mb.shape[0] // 2], *a, **k)
M.ppo_grad_step_gather2 = broken
""",
        # the rollout's rewards altered where they are produced
        "answer_altered": FUSED + altered("reward", "x * 1.1"),
        # faults that start once set-up is over: from the fourth iteration (the
        # window's first), the update is dropped or the rewards are altered
        "state_unchanged_after_setup": FUSED + """
orig = M._update_packed
n = [0]
def broken(cfg, opt, params, opt_state, *a, **k):
    n[0] += 1
    new = orig(cfg, opt, params, opt_state, *a, **k)
    return (params, opt_state, new[2]) if n[0] > 3 else new
M._update_packed = broken
""",
        "answer_altered_after_setup": FUSED + """
orig = M.rollout
n = [0]
def broken(*a, **k):
    n[0] += 1
    out = orig(*a, **k)
    if n[0] > 3:
        out["reward"] = out["reward"] * 1.1
    return out
M.rollout = broken
""",
    },
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_unbroken_runs_are_correct(tiny_tree, cell):
    assert drive(tiny_tree, cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(tiny_tree, cell, fault):
    res = drive(tiny_tree, cell, patch=FAULTS[cell][fault])
    assert res["correct"] is False, res["checks"]
