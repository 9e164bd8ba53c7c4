"""A configuration, a cell, a per-layer metric and a count are each added
as a new file (and a new entry of BENCHMARK.json), with no existing file of
the benchmark edited, and the harness finds and runs them by name."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark.harness.trace import HOST, KERNEL
from benchmark.tests.conftest import drive

NEW_COUNT = '''"""K1a's bytes alone, a launch."""
from benchmark.counts import k1a


def count(B, T, sample_time=3, controller="pid"):
    return dict(k1a.count(B, T, sample_time, controller), flop=0.0, sfu=0.0)
'''
NEW_METRIC = '''"""K1a's share of its bytes' roofline."""
from benchmark.counts import k1a_bytes
from benchmark.harness import layer


def read(rec):
    wl = rec["workload"]
    return layer.roofline_pct(rec, r"rollout_kernel", k1a_bytes.count(wl["batch"], wl["steps"], 5))
'''


def test_new_files_are_found_by_name(tiny_tree):
    before = {}
    for dirpath, _, files in os.walk(os.path.join(tiny_tree, "benchmark")):
        for f in files:
            p = os.path.join(dirpath, f)
            before[p] = open(p, "rb").read()
    b = os.path.join(tiny_tree, "benchmark")
    with open(os.path.join(b, "configs", "cohort.json")) as f:
        conf = json.load(f)
    conf.update(name="cohort_guardian", sensor="GuardianRT", sample_time=5)
    with open(os.path.join(b, "configs", "cohort_guardian.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(b, "workloads", "cohort_guardian.pid128_2h.json"), "w") as f:
        json.dump({"config": "cohort_guardian", "traffic": "pid128_2h", "entry": "rollout_summary",
                   "chips": 1, "why": "GuardianRT's 5-minute samples", "batch": 128, "steps": 24,
                   "controller": "pid", "autoreset": True, "random_init_bg": True,
                   "check_calls": 2, "check_lanes": 16, "check_threads": 1,
                   "limits": {"lanes_off": 0.05, "bg_gap_median": 1e-05}}, f)
    with open(os.path.join(b, "counts", "k1a_bytes.py"), "w") as f:
        f.write(NEW_COUNT)
    with open(os.path.join(b, "metrics", "k1a_bytes_roofline.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(tiny_tree, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "cohort_guardian", "source": "simglucose v0.2.2",
                             "file": "benchmark/configs/cohort_guardian.json", "reduced": [],
                             "why": "GuardianRT"})
    bench["workloads"].append({"name": "cohort_guardian.pid128_2h", "config": "cohort_guardian",
                               "traffic": "pid128_2h", "chips": 1, "why": "GuardianRT"})
    for m in bench["end_to_end"]:
        if m["name"] == "sim_env_steps_per_s":
            m["workloads"].append("cohort_guardian.pid128_2h")
    bench["per_layer"].append({"name": "k1a_bytes_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "Kernels K1a, K1b",
                               "moves": "sim_env_steps_per_s",
                               "workloads": ["cohort_guardian.pid128_2h"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    for p, data in before.items():  # no file that was there changed
        assert open(p, "rb").read() == data, p

    res = drive(tiny_tree, "cohort_guardian.pid128_2h")
    assert res["correct"] is True and set(res["metrics"]) == {"sim_env_steps_per_s", "setup_s"}
    probe = "\n".join([
        f"import sys, json; sys.path.insert(0, {tiny_tree!r})", "from benchmark import run",
        "from benchmark.harness.trace import Event",
        f"b = run.load_json({path!r})",
        "names = [m['name'] for m in run.metrics_of(b, 'cohort_guardian.pid128_2h', True)]",
        "mod = run.load_module('metrics', 'k1a_bytes_roofline')",
        f"ev = [Event('cudaLaunchKernel', {HOST!r}, 0.0, 1.0),"
        f" Event('rollout_kernel', {KERNEL!r}, 0.0, 50.0)]",
        "rec = dict(events=ev, trace_window_us=(0.0, 100.0), calls=1,"
        " workload=dict(batch=128, steps=24))",
        "print(json.dumps([names, mod.read(rec)]))"])
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names, share = json.loads(out.stdout)
    assert names == ["k1a_bytes_roofline"]
    want_s = 4 * (50 * 128 + 6 * 128 * 24 + 2 * 128 + 71 * 128) / 3.35e12
    assert abs(share - 100 * want_s / 50e-6) < 1e-9
