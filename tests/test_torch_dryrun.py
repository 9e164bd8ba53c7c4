"""The multi-rank dry run (``parallel/dryrun.py``), the backend its spawned
ranks take, and ``chip_smoke.py``'s four-card guard and its ranks' host
threads.

One spawn of four gloo ranks on the CPU (tests/test_torch_multidevice_sim.py's
``spawn_ranks``) runs ``dryrun_multichip(4, device="cpu")`` inside their
live group, all five stages of ``__graft_entry__.py::dryrun_multichip`` at
its shapes, and then each stage's check on inputs made to fail on one rank:
every rank must raise, naming the rank.  The stages' one-process results
are held against JAX elsewhere (the dry run's docstring names the tests);
the spawning form runs in tests/test_torch_multidevice_learner.py (two
ranks) and tests/test_torch_multidevice_tp.py (four).
"""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from simglucose_tpu_torch.parallel import dryrun, multihost

from test_torch_multidevice_sim import REPO, spawn_ranks

torch.set_num_threads(1)

N_RANKS = 4
FAILING_RANK = 2

WORKER = textwrap.dedent(
    """
    import contextlib, io, json, os, sys
    import numpy as np, torch
    rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from simglucose_tpu_torch.parallel.multihost import process_group
    with process_group(f"file://{store}", world_size=n, rank=rank, backend="gloo"):
        from simglucose_tpu_torch.parallel import dryrun as dr
        from simglucose_tpu_torch.parallel.sharding import make_mesh

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = dr.dryrun_multichip(n, device="cpu")
        res = dict(summary=json.dumps(summary), printed=printed.getvalue())

        def caught(fn):
            try:
                fn()
            except RuntimeError as e:
                return str(e)
            return ""

        mesh, bad = make_mesh(dp=n), FAILING_RANK
        # stages (a), (b), (d), (e): one rank's params differ
        flat = torch.linspace(-1.0, 1.0, 9)
        res["params_same"] = caught(lambda: dr.same_on_ranks(flat, mesh, "the params"))
        res["params_differ"] = caught(lambda: dr.same_on_ranks(
            flat + 1e-7 * (rank == bad), mesh, "the params"))
        # stage (c): one rank's rows differ from the one-process rollout
        whole = torch.arange(2 * 8 * n, dtype=torch.float32).reshape(2, 8 * n)
        lanes = slice(rank * 8, (rank + 1) * 8)
        got = whole[:, lanes].clone()
        res["rows_same"] = caught(lambda: dr.on_every_rank(
            mesh, lambda: dr.rows_equal(got, whole, lanes, "BG")))
        got[1, 3] += float(rank == bad)
        res["rows_differ"] = caught(lambda: dr.on_every_rank(
            mesh, lambda: dr.rows_equal(got, whole, lanes, "BG")))
        # stage (e): the episodes not carried on one rank, the state too large
        t0 = torch.tensor([6, 30, 600, 9], dtype=torch.int32)
        t1 = t0 + 6 * (rank != bad)
        res["carried"] = caught(lambda: dr.on_every_rank(
            mesh, lambda: dr.check_continued(t0, t0 + 6, 6)))
        res["not_carried"] = caught(lambda: dr.on_every_rank(
            mesh, lambda: dr.check_continued(t0, t1, 6)))
        res["state_mb"] = dr.check_state_bytes(2_330_000)
        res["state_too_large"] = caught(lambda: dr.check_state_bytes(100_000_001))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    """
).replace("FAILING_RANK", str(FAILING_RANK))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(WORKER, tmp_path_factory.mktemp("dryrun"), n=N_RANKS)


def test_dryrun_in_a_live_group_runs_the_five_stages(ranks):
    """``dryrun_multichip(4, device="cpu")`` on the group's four ranks: the
    JAX function's stages at its shapes, the same summary on every rank,
    and rank 0 alone printing the OK line with the mesh and the backend."""
    import json

    summaries = [json.loads(str(r["summary"])) for r in ranks]
    assert all(s == summaries[0] for s in summaries)
    s = summaries[0]
    assert s["mesh"] == [2, 2] and s["B"] == 8 and s["tp_parity"]
    assert s["kernel_dp"] == 4 and s["Bk"] == 4 * 128
    assert s["B32"] == dryrun.B_PERSISTENT == 32768
    # (64 float + 7 int planes) x 4 B x 8192 lanes a rank
    assert s["state_mb"] == pytest.approx((64 + 7) * 4 * 8192 / 1e6)
    assert 0 < s["carried_lanes"] <= 32768
    assert s["backend"] == "cpu:gloo,cuda:gloo"
    for k in ("reward_mean", "fused_reward", "reward32"):
        assert np.isfinite(s[k])
    line = str(ranks[0]["printed"]).strip()
    assert line.startswith("dryrun_multichip OK: mesh=(dp=2,tp=2), backend=cpu:gloo")
    for field in ("tp=2 vs tp=1 learner parity OK", "sharded rollout kernel OK (dp=4, B=512)",
                  "fused PPO step OK", "32K-lane persistent fused trainer OK (B=32768, hidden=64",
                  "MB/rank"):
        assert field in line
    assert all(str(r["printed"]) == "" for r in ranks[1:])


@pytest.mark.parametrize("case, passing", [("params", "params_same"), ("rows", "rows_same"),
                                           ("carried", "carried")])
def test_each_stage_check_raises_on_every_rank(ranks, case, passing):
    """A check that one rank fails raises on every rank and names it: the
    params after an update (stages a, b, d, e), the sharded rollout's rows
    against one process (c), the episodes carried into the second
    iteration (e).  On equal inputs nothing raises."""
    failing = {"params": "params_differ", "rows": "rows_differ", "carried": "not_carried"}[case]
    for r in ranks:
        assert str(r[passing]) == ""
        msg = str(r[failing])
        assert f"rank(s) [{FAILING_RANK}]" in msg, msg


def test_the_persistent_state_is_held_under_its_limit(ranks):
    """Stage (e)'s state bound: 2.33 MB a rank passes, 100 MB raises."""
    for r in ranks:
        assert float(r["state_mb"]) == pytest.approx(2.33)
        assert "limit 100.0 MB" in str(r["state_too_large"])


@pytest.mark.parametrize("device, cards, n, want", [
    ("cpu", 0, 4, "gloo"),
    ("cpu", 8, 4, "gloo"),
    ("cuda", 1, 4, "gloo"),  # four ranks sharing one card
    ("cuda", 2, 4, "gloo"),
    ("cuda", 4, 4, "cpu:gloo,cuda:nccl"),  # a card a rank
    ("cuda", 8, 2, "cpu:gloo,cuda:nccl"),
])
def test_spawned_ranks_take_nccl_only_with_a_card_each(monkeypatch, device, cards, n, want):
    """``spawn_backend``: the default backend (NCCL for card tensors, gloo
    for host ones) where each spawned rank has a card of its own, gloo
    where ranks share a card or run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.spawn_backend(n, device) == want


@pytest.mark.parametrize("rank_from", ["arguments", "environment"])
def test_each_rank_sits_on_its_card_before_the_group_forms(monkeypatch, rank_from):
    """``multihost.initialize`` puts rank r on card ``r % cards`` before
    ``init_process_group``: NCCL binds a communicator to the current card
    at its first collective on any group, sub-groups included, so a rank
    still on card 0 then would share it.  The rank comes from the
    arguments or from torch's environment (``RANK``, as ``torchrun`` sets
    it)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda k: calls.append(("set_device", k)))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", kw["rank"])))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 6)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(multihost.dist, "get_backend", lambda: "nccl")
    if rank_from == "arguments":
        multihost.initialize("file:///no-store", world_size=8, rank=6, backend="nccl")
        passed = 6
    else:
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"), ("RANK", "6"),
                     ("WORLD_SIZE", "8")):
            monkeypatch.setenv(k, v)
        multihost.initialize(backend="nccl")
        passed = -1  # torch reads it from the environment
    assert calls[:2] == [("set_device", 2), ("init", passed)]


def test_dryrun_entry_spawns_its_ranks(capsys):
    """``python -m simglucose_tpu_torch.parallel.dryrun N --device cpu``
    outside a group spawns N gloo ranks, says so, and prints the OK line."""
    s = dryrun.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dryrun_multichip: 2 ranks spawned on cpu over gloo (0 cards)"
    assert out[-1] == dryrun.ok_line(s)
    assert s["mesh"] == (1, 2) and s["Bk"] == 256 and s["state_mb"] == pytest.approx(
        (64 + 7) * 4 * 16384 / 1e6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("available, cards", [(False, 0), (True, 1), (True, 3)])
def test_four_card_mode_refuses_fewer_cards(monkeypatch, capsys, available, cards):
    """``chip_smoke.py --cards 4`` exits non-zero with fewer than four
    visible cards, before it builds or spawns anything: no fallback to
    shared cards or gloo."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit) as e:
        cs.cards_main(4)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_four_card_mode_fails_here_as_a_process():
    """The same guard through the command line, with every card hidden
    (so on any machine): a non-zero exit and no result line."""
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--cards", "4"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "--cards 4" in p.stderr


@pytest.mark.parametrize("preset, want", [(None, "1"), ("6", "6")])
def test_rank_processes_get_one_host_thread(monkeypatch, preset, want):
    """``chip_smoke.py``'s rank processes get one torch host thread unless
    ``OMP_NUM_THREADS`` says otherwise, as ``torchrun``'s processes do:
    four ranks each taking a thread per core oversubscribe the host."""
    cs = _chip_smoke()
    if preset is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", preset)
    seen = []

    class Started(Exception):
        pass

    def popen(cmd, env=None, **kw):
        seen.append((cmd[-4:], env["OMP_NUM_THREADS"]))
        raise Started

    monkeypatch.setattr(cs.subprocess, "Popen", popen)
    with pytest.raises(Started):
        cs.md_spawn("cards", 4, "workdir")
    assert seen == [(["cards", "0", "4", "workdir"], want)]
