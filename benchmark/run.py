"""The benchmark of simglucose_tpu_torch: one cell, one run, one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: ``BENCHMARK.json`` at the root names
the cell and its metrics, ``benchmark/workloads/<cell>.json`` its
configuration, entry and traffic, ``benchmark/configs/<config>.json`` the
configuration, ``benchmark/drivers/<entry>.py`` the code that drives the
program, ``benchmark/metrics/<metric>.py`` each metric's reader.

A run: set-up (the driver builds the program's state from the seed and
warms every shape the cell uses), then closed-loop calls back to back
until ``--seconds`` have passed, the last call completed.  With ``--trace
1`` an untraced window of at most ``UNTRACED_SECONDS`` (the metrics read
from the host's clock) is followed by one of at most ``TRACE_SECONDS``
under ``torch.profiler``, recording the card's activity alone (kernels,
copies and the CUDA calls that issue them) so that the host's own time
is not stretched.  Then the driver compares what the timed calls
produced with the plain reference (``benchmark/reference/``).  The last lines on standard error are the
numbers compared, each beside its limit; the last line on standard output
is the result.  Exits non-zero, with no result, where CUDA or the cell's
cards are missing, where the program cannot be imported, or where JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "simglucose_tpu")
# the longest traced window: the reading of its events grows with the
# window, and a traced run has to end in minutes
TRACE_SECONDS = 5.0
# the untraced window a traced run measures first, for the per-layer
# metrics read from the host's clock
UNTRACED_SECONDS = 10.0


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``benchmark/<kind>/<name>.py``, loaded by path (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        fail(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str, bench: dict) -> tuple:
    """(BENCHMARK.json's entry, the workload file, the configuration file)
    of cell ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        fail(f"BENCHMARK.json has no workload {name!r}")
    wl = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, wl, load_json(os.path.join(ROOT, conf["file"]))


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The metric entries the cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card(index: int = 0) -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    import torch

    out = {"kind": torch.cuda.get_device_name(index), "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return out


def measure(runner, seconds: float, trace: bool) -> dict:
    """Closed-loop calls back to back until ``seconds`` have passed: each
    call's host-clock latency; the window from the first call's start to
    the last one's end.  With ``trace`` the window runs under
    ``torch.profiler``, recording the card's activity alone."""
    import torch

    from benchmark.harness import trace as tr

    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    lat = []
    t0 = time.perf_counter()
    t1 = t0
    while t1 - t0 < seconds:
        a = time.perf_counter()
        runner.call()
        t1 = time.perf_counter()
        lat.append(t1 - a)
    rec = {"latencies_s": lat, "calls": len(lat), "window_s": t1 - t0}
    if prof is not None:
        prof.stop()
        rec["events"] = tr.from_profiler(prof)
    return rec


def held_to_peak(name: str, unit: str, value: float) -> float:
    """A share of a roofline or a peak above 105% means its count or its
    time is wrong: exit, with no result, rather than print it."""
    if unit == "%" and value > 105.0:
        fail(f"{name} reads {value:.4f}% of a peak: its count or its time is wrong", 3)
    return value


def check_cards(chips: int):
    """Exit, with no result, unless CUDA and ``chips`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards; {torch.cuda.device_count()} are visible")


def run_cell(workload: str, seed: int, seconds: float, trace: bool = False, device="cuda",
             look_for_cards: bool = True, after_check=None) -> dict:
    """One run of cell ``workload``; returns the result line's object.
    ``device`` and ``look_for_cards`` let the CPU tests drive a run at a
    tiny size with the program's plain versions; ``after_check(runner)``
    (calibration) is called once the comparison is made."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry, wl, conf = cell_files(workload, bench)
    driver = load_module("drivers", wl["entry"])
    readers = {m["name"]: (m, load_module("metrics", m["name"]))
               for m in metrics_of(bench, workload, trace)}
    if look_for_cards:
        check_cards(entry["chips"])
    import torch

    torch.set_num_threads(1)  # one process, few threads: steadier host times
    ctx = types.SimpleNamespace(seed=seed, workload=wl, config=conf, chips=entry["chips"],
                                trace=trace, root=ROOT, device=torch.device(device))
    runner = driver.setup(ctx)
    setup_s = time.perf_counter() - T_START
    untraced = measure(runner, min(seconds, UNTRACED_SECONDS), False) if trace else None
    rec = measure(runner, min(seconds, TRACE_SECONDS) if trace else seconds, trace)
    rec.update(setup_s=setup_s, work=rec["calls"] * runner.work_per_call, workload=wl,
               config=conf, untraced=untraced)
    attempted = rec["calls"] + (untraced["calls"] if untraced else 0)
    peak = runner.memory_peak_bytes()
    out_metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        from benchmark.harness import trace as tr

        lo_hi = tr.window(rec["events"])
        if lo_hi is None:
            fail("the trace holds no device event", 3)
        rec["trace_window_us"] = lo_hi
        dev_extra = dict(busy_s=tr.busy_us(rec["events"], *lo_hi) * 1e-6,
                         window_s=(lo_hi[1] - lo_hi[0]) * 1e-6)
        breakdown = tr.breakdown(rec["events"], *lo_hi)
    for name, (m, mod) in readers.items():
        value = mod.read(rec)
        if value is not None:
            out_metrics[name] = {"value": float(held_to_peak(name, m["unit"], value)),
                                 "unit": m["unit"]}
    rec.pop("events", None)
    checks = runner.check(rec)
    if after_check is not None:
        after_check(runner)
    found = forbidden_loaded()
    if found:
        fail(f"modules of {', '.join(found)} were loaded in the process", 4)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    info = card(0) if look_for_cards else {"kind": str(device), "power_limit": None}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks),
        "attempted": attempted, "failed": int(runner.failed), "metrics": out_metrics,
        "device": dict(platform="gpu" if look_for_cards else str(device), kind=info["kind"],
                       count=entry["chips"], memory_peak_bytes=int(peak), **dev_extra),
        "power_limit": info["power_limit"], "seed": seed, "setup_s": setup_s,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
        # the profiler's cost to the host: calls a second, untraced and traced
        result["trace_cost"] = {"untraced_calls_per_s": untraced["calls"] / untraced["window_s"],
                                "traced_calls_per_s": rec["calls"] / rec["window_s"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
