"""The port's bench on two gloo ranks on the CPU: the headline over a
``(2, 1)`` mesh, as the JAX bench's ``shard_map`` branch runs it.

One spawn of two ranks (a ``file://`` store under the test's temporary
directory, one torch thread a rank) runs ``bench_pallas`` at 256 lanes a
rank over 160 steps (the plain version; the law bands hold there).  Then,
with torchrun's environment set (``MASTER_ADDR``, ``MASTER_PORT`` on
localhost, ``RANK``, ``WORLD_SIZE``), ``main`` joins a group of its own
and runs the same bench with its lead-only sections stubbed.  Rank 1's
rollout sleeps after each call, so the ranks' times differ.  Each rank
writes its results as JSON; the module-scoped fixture reads them:

* the global law stats (float64 sums over the ranks, then the squared
  deviations from the global mean) equal one process's ``_law_stats`` of
  the same 512 lanes at the last timed call's key, within 1e-6 relative,
  and are the same on both ranks: draws are keyed by global lane;
* a round's time is the slower rank's: the rate every rank returns is the
  best round's lanes x steps over the larger of the two ranks' times;
* ``main`` joins and leaves the group torchrun's environment describes,
  and only rank 0 prints its line.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.tools import bench as tbench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
SPAWN_TIMEOUT_S = 300
LANES, STEPS = 256, 160
SLOW_S = 0.3

WORKER = textwrap.dedent(
    """
    import contextlib, functools, io, json, os, sys, time
    import torch
    rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    lanes, steps, slow, port = int(sys.argv[5]), int(sys.argv[6]), float(sys.argv[7]), sys.argv[8]
    torch.set_num_threads(1)
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.parallel.multihost import process_group
    from simglucose_tpu_torch.parallel.sharding import make_mesh
    from simglucose_tpu_torch.tools import bench

    rounds = []

    class Recorded(bench.Throughput):
        def stop(self, calls=1):
            super().stop(calls)
            rounds.append(self.elapsed)

    bench.Throughput = Recorded
    if rank == 1:
        sharded = tr.make_sharded_rollout

        def slow_sharded(*a, **kw):
            run = sharded(*a, **kw)

            def slow_run(*b, **kwb):
                out = run(*b, **kwb)
                time.sleep(slow)
                return out
            return slow_run

        tr.make_sharded_rollout = slow_sharded
    with process_group(f"file://{store}", world_size=n, rank=rank, backend="gloo"):
        mesh = make_mesh()
        rate, stats = bench.bench_pallas(lanes, steps, 1, device="cpu", mesh=mesh)
        timed = rounds[:]
    # torchrun's environment: main joins the group for its run and leaves it
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(n))
    bench.bench_pallas = functools.partial(bench.bench_pallas, lanes)
    bench.law_gate_other_sensors = lambda *a, **kw: {}
    bench.bench_fused_ppo = lambda *a, **kw: (2.0e6, 3.0)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ret = bench.main([], n_steps=steps, n_calls=1, device="cpu")
    assert not torch.distributed.is_initialized()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rate=rate, stats=stats, rounds=timed, printed=printed.getvalue(),
                       returned=ret), f)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("bench_ranks"))
    store = os.path.join(workdir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(N_RANKS), store,
                               workdir, str(LANES), str(STEPS), str(SLOW_S), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(N_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
                                       for r, (p, log) in enumerate(zip(procs, logs))))
    out = []
    for r in range(N_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def test_global_law_stats_equal_one_process(ranks):
    assert ranks[0]["stats"] == ranks[1]["stats"]
    packed = tbench._packed(N_RANKS * LANES, "cpu")
    # bench_pallas's last timed call: round 1, call 0 of 1 -> key (2, 0)
    traj = tr.rollout(tr.RolloutConfig(n_steps=STEPS, controller="pid"), packed, (2, 0))
    want = {k: float(v) for k, v in tbench._law_stats(traj, 3).items()}
    for k, v in ranks[0]["stats"].items():
        assert abs(v - want[k]) <= 1e-6 * abs(want[k]), (k, v, want[k])


def test_round_time_is_the_slowest_ranks(ranks):
    r0, r1 = ranks[0]["rounds"], ranks[1]["rounds"]
    assert len(r0) == len(r1) == 2
    # the ranks' own times differ (rank 1 sleeps; under load either rank may
    # be the slower), so only the slower one's gives every rank this rate
    assert all(a != b for a, b in zip(r0, r1)), (r0, r1)
    want = max(N_RANKS * LANES * STEPS / max(a, b) for a, b in zip(r0, r1))
    for r in ranks:
        assert r["rate"] == pytest.approx(want, rel=1e-12)


def test_only_rank_zero_prints(ranks):
    lines = ranks[0]["printed"].strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == ranks[0]["returned"]
    assert ranks[0]["returned"]["fused_ppo_iters_per_sec"] == 3.0
    assert ranks[1]["printed"] == "" and ranks[1]["returned"] is None
