"""The readings a cell's limits are set from (not run by the benchmark's
runs): the program's numbers over many seeds, each a short run of the cell,
and the control's (the reference in bfloat16 in the program's place) and,
where the driver plants them, its faults' over a few.  Where the driver
holds window calls to the reference from the state each started from
(``window_readings``), the first ``--control-seeds`` runs also read the
control and the faults in the program's place at those calls, and every
run reads ``window_look`` (each kept call's numbers beside what set the
two sides apart).

    python3 benchmark/calibrate.py <cell> [--seeds N] [--control-seeds M] [--seconds S]
        [--start-controls K] [--base-seed B]

One JSON line per reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run  # noqa: E402

BASE_SEED = 7_000_000_000


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("cell")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--base-seed", type=int, default=BASE_SEED)
    p.add_argument("--start-controls", type=int, default=None,
                   help="seeds for the control and faults from the seed (default: --control-seeds)")
    args = p.parse_args(argv)
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    entry, wl, conf = run.cell_files(args.cell, bench)
    driver = run.load_module("drivers", wl["entry"])
    out = lambda **kv: print(json.dumps(dict(cell=args.cell, **kv)), flush=True)
    for i in range(args.seeds):
        seed = args.base_seed + 7919 * i

        def window(runner, seed=seed, i=i):
            if hasattr(runner, "window_look"):
                out(kind="window.look", seed=seed, calls=runner.window_look())
            if i < args.control_seeds and hasattr(runner, "window_readings"):
                for kind in ("control", "half_batch"):
                    out(kind=f"window.{kind}", seed=seed, numbers=runner.window_readings(kind))

        res = run.run_cell(args.cell, seed, args.seconds, after_check=window)
        out(kind="program", seed=seed, correct=res["correct"],
            numbers={k: v["value"] for k, v in res["checks"].items()})
    n_start = args.control_seeds if args.start_controls is None else args.start_controls
    for i in range(n_start):
        seed = args.base_seed + 104729 * (i + 1)
        out(kind="control", seed=seed, numbers=driver.control(conf, wl, seed))
        if hasattr(driver, "fault"):
            out(kind="fault.half_batch", seed=seed, numbers=driver.fault(conf, wl, seed))


if __name__ == "__main__":
    main()
