"""The frozen counts against hand-worked values."""
from __future__ import annotations

import pytest

from benchmark.counts import k1a, k1b, ppo_grad_step
from benchmark.harness import peaks


def test_k1a_pid_step():
    flop, sfu = k1a.per_step(3, "pid")
    # 3 minutes (145 fma, 141 mul, 15 div, 55 select, 8 tanh each), the
    # step's own 6 fma + 18 mul + 2 div + 6 select, a fifth of a lattice
    # point (1 fma + 9 mul + 3 div + 2 select), the PID's 3 fma + 6 mul +
    # 3 div + 2 select
    assert flop == pytest.approx(3 * (2 * 145 + 141 + 15 + 55) + (12 + 18 + 2 + 6)
                                 + (2 + 9 + 3 + 2) / 5 + (6 + 6 + 3 + 2))
    assert int(flop) == 1561
    assert sfu == pytest.approx(3 * 8 + 3 + 3 / 5)


def test_k1a_call_and_bb():
    c = k1a.count(4096, 480)
    assert c["flop"] == pytest.approx(4096 * 480 * 1561.2)
    assert c["bytes"] == 4 * (50 * 4096 + 6 * 4096 * 480 + 2 * 4096 + 71 * 4096)
    assert k1a.per_step(3, "bb")[0] == pytest.approx(1561.2 - 17)


def test_grad_step():
    assert ppo_grad_step.flop(131072, 64) == 3623878656
    assert ppo_grad_step.count(131072, 64)["bytes"] == 48 * 131072


def test_k1b_adds_the_policy():
    base = k1a.count(8192, 64, controller="nn")
    c = k1b.count(8192, 64, 64)
    assert c["flop"] - base["flop"] == 8192 * 64 * (2 * (9 * 64 + 64 * 64) + 25)
    assert c["flop"] == pytest.approx(5.72166e9, rel=1e-5)


def test_bound_takes_the_slowest_pipe():
    assert peaks.bound_s(flop=67e12, bytes=0) == pytest.approx(1.0)
    assert peaks.bound_s(flop=0, bytes=3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(flop=1, bytes=1, sfu=peaks.SFU_OPS_PER_S) == pytest.approx(1.0)
