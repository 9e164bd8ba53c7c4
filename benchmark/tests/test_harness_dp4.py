"""The four-rank cell on the CPU: four gloo ranks (rank 0 the run's own
process, three spawned workers) at a tiny size, 8 patients x 2 h.  An
honest run is correct with the ranks and one process bit for bit; each
fault the driver can plant makes it not correct; a worker killed in the
window ends the run, non-zero, within the watchdog's limit; two runs in
one process both complete; the cell's three metrics read a synthetic
trace."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from benchmark import run
from benchmark.harness import links
from benchmark.harness.trace import COPY, HOST, KERNEL, Event
from benchmark.tests.conftest import _update, drive, make_tree
from simglucose_tpu_torch.utils.profiling import Span

CELL = "cohort_dp4.bb4096_1d"
TINY = dict(patients=8, hours=2, check_lanes=16, check_threads=1)
FAULTS = ("lane_offset", "gather_order", "no_exchange", "one_ulp")
WATCHDOG_S = 60.0


@pytest.fixture
def tree(tmp_path):
    t = make_tree(str(tmp_path))
    _update(os.path.join(t, "benchmark", "workloads", f"{CELL}.json"), TINY)
    return t


def with_fault(tree: str, fault: str):
    _update(os.path.join(tree, "benchmark", "workloads", f"{CELL}.json"), {"fault": fault})


def interpreter(tree: str, body: str, timeout: float):
    """``body`` in a fresh interpreter at ``tree``'s root."""
    src = f"import json, sys\nsys.path.insert(0, {tree!r})\n" + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=tree)


def test_an_honest_run_is_correct(tree):
    res = drive(tree, CELL, seconds=1.0)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["ranks_apart"]["value"] == 0.0
    assert res["checks"]["single_apart"]["value"] == 0.0
    assert res["device"]["count"] == 4 and res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(tree, fault):
    with_fault(tree, fault)
    res = drive(tree, CELL, seconds=0.5)
    assert res["correct"] is False, res["checks"]


def test_the_calibration_faults_read_above_the_limits(tree):
    out = interpreter(tree, f"""
        from benchmark import run
        bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
        _, wl, conf = run.cell_files({CELL!r}, bench)
        driver = run.load_module("drivers", wl["entry"])
        print(json.dumps([wl["limits"], driver.fault(conf, wl, 11)]))
        """, 300)
    assert out.returncode == 0, out.stderr[-4000:]
    limits, got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got) == set(FAULTS)
    for f, nums in got.items():
        assert any(nums[k] > limits[k] for k in limits), (f, nums)
    assert got["one_ulp"]["ranks_apart"] > limits["ranks_apart"]
    assert got["lane_offset"]["single_apart"] > limits["single_apart"]


def test_a_killed_worker_ends_the_run(tree):
    """A worker killed mid-window: the run exits non-zero with no result
    line within the watchdog's limit of the kill."""
    out = interpreter(tree, f"""
        import os, signal, threading, time
        from benchmark import run

        def children():
            # the workers: this process's children that multiprocessing
            # spawned (not its resource tracker)
            me = str(os.getpid())
            out = []
            for d in os.listdir("/proc"):
                if d.isdigit():
                    try:
                        with open(f"/proc/{{d}}/stat") as f:
                            ppid = f.read().rsplit(")", 1)[1].split()[1]
                        with open(f"/proc/{{d}}/cmdline", "rb") as f:
                            spawned = b"spawn_main" in f.read()
                    except OSError:
                        continue
                    if ppid == me and spawned:
                        out.append(int(d))
            return out

        def killer():
            while len(children()) < 3:
                time.sleep(0.2)
            time.sleep(6.0)
            print(f"killed {{time.time()}}", file=sys.stderr, flush=True)
            os.kill(min(children()), signal.SIGKILL)

        threading.Thread(target=killer, daemon=True).start()
        res = run.run_cell({CELL!r}, 7, 120.0, device="cpu", look_for_cards=False)
        print(json.dumps(res))
        """, 300)
    ended = time.time()
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    killed = [float(line.split()[1]) for line in out.stderr.splitlines()
              if line.startswith("killed ")]
    assert killed and ended - killed[0] < WATCHDOG_S, out.stderr[-3000:]


def test_a_blocked_rank_ends_the_run(tree):
    """A worker stopped (SIGSTOP) mid-window leaves rank 0 in a collective
    that never returns: the watchdog ends the run, non-zero and with no
    result line, once the call outlasts its deadline (cut to 5 s here)."""
    out = interpreter(tree, f"""
        import os, signal, threading, time
        from benchmark import run
        from benchmark.harness import ranks
        ranks.CALL_S = 5.0

        def stopper():
            while not hasattr(ranks, "live"):
                time.sleep(0.2)
            time.sleep(4.0)
            print(f"stopped {{time.time()}}", file=sys.stderr, flush=True)
            os.kill(ranks.live.procs[0].pid, signal.SIGSTOP)

        orig = ranks.Ranks.__init__
        def init(self, *a, **k):
            orig(self, *a, **k)
            ranks.live = self
        ranks.Ranks.__init__ = init
        threading.Thread(target=stopper, daemon=True).start()
        res = run.run_cell({CELL!r}, 9, 120.0, device="cpu", look_for_cards=False)
        print(json.dumps(res))
        """, 300)
    ended = time.time()
    assert out.returncode == 5, out.stderr[-3000:]
    assert '"correct"' not in out.stdout and "outlasted its deadline" in out.stderr
    stopped = [float(line.split()[1]) for line in out.stderr.splitlines()
               if line.startswith("stopped ")]
    assert stopped and ended - stopped[0] < 5.0 + 10.0, out.stderr[-3000:]


def test_two_runs_in_one_process(tree):
    out = interpreter(tree, f"""
        from benchmark import run
        a = run.run_cell({CELL!r}, 21, 0.5, device="cpu", look_for_cards=False)
        b = run.run_cell({CELL!r}, 22, 0.5, device="cpu", look_for_cards=False)
        import torch.distributed as dist, multiprocessing as mp
        print(json.dumps([a["correct"], b["correct"], dist.is_initialized(),
                          len(mp.active_children())]))
        """, 300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True, False, 0]


def synthetic():
    """Two traced calls: each two all-gathers on the card (800 + 10 us, and
    the ring's second kernel name), a copy, and two ``mesh.gather`` spans of
    3 + 1 ms on the host."""
    ev = [Event("cudaLaunchKernel", HOST, 0.0, 5.0)]
    spans = []
    for k in range(2):
        t = 10_000.0 * k
        ev += [Event("rollout_kernel", KERNEL, t, t + 3000.0),
               Event("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)",
                     KERNEL, t + 3000.0, t + 3800.0),
               Event("ncclKernel_AllGather_RING_LL_Sum_int8_t", KERNEL, t + 3900.0, t + 3910.0),
               Event("Memcpy DtoH (Device -> Pageable)", COPY, t + 4000.0, t + 9000.0)]
        b = 10 ** 12 + k * 10 ** 7
        spans += [Span("simulate_cohort", b, b + 9 * 10 ** 6, -1, k, {}),
                  Span("mesh.gather", b + 10 ** 6, b + 4 * 10 ** 6, 0, k, {"bytes": 10}),
                  Span("mesh.gather", b + 4 * 10 ** 6, b + 5 * 10 ** 6, 0, k, {"bytes": 1})]
    wl, conf = run.load_json(os.path.join(run.HERE, "workloads", f"{CELL}.json")), run.load_json(
        os.path.join(run.ROOT, "benchmark", "configs", "cohort_dp4.json"))
    return {"events": ev, "trace_window_us": (0.0, 20_000.0), "calls": 2, "spans": spans,
            "anchors": [], "workload": wl, "config": conf}


def test_the_new_metrics_read_a_synthetic_trace():
    rec = synthetic()
    read = lambda m: run.load_module("metrics", m).read(rec)
    assert read("collective_ms.dp4") == pytest.approx(0.81)
    assert read("gather_ms.dp4") == pytest.approx(4.0)
    gathered = 4 * (4 * 480 + 2) * 16384
    assert gathered == 125_960_192
    want = 100 * 0.75 * gathered * 2 / (2 * 810e-6) / 450e9
    assert read("gather_busbw.dp4") == pytest.approx(want)
    assert links.busbw_pct(450e9 * 4 / 3, 4, 1.0) == pytest.approx(100.0)
    rec["events"] = [e for e in rec["events"] if "nccl" not in e.name]
    rec["spans"] = [s for s in rec["spans"] if s.name != "mesh.gather"]
    assert read("collective_ms.dp4") is None and read("gather_busbw.dp4") is None
    assert read("gather_ms.dp4") is None
