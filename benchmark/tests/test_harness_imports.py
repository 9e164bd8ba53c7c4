"""What the benchmark loads: no JAX and no JAX package anywhere it runs,
and nothing of the program in the reference.  Top-level module names are
compared whole, in a fresh interpreter (``simglucose_tpu_torch`` begins
with ``simglucose_tpu``)."""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from benchmark.tests.conftest import BENCH, ROOT, drive

FORBIDDEN = {"jax", "jaxlib", "flax", "simglucose_tpu"}


def top_level_after(src: str) -> set:
    probe = src + ("\nimport json, sys\n"
                   "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def modules(kind: str) -> list:
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(BENCH, kind, "*.py"))
                  if not p.endswith("__init__.py"))


def test_every_module_the_benchmark_runs_loads_no_jax():
    src = ["import sys", f"sys.path.insert(0, {ROOT!r})", "from benchmark import run, calibrate"]
    for kind in ("drivers", "metrics", "counts"):
        src += [f"run.load_module({kind!r}, {m!r})" for m in modules(kind)]
    src += ["import simglucose_tpu_torch.rl.fused, simglucose_tpu_torch.sim.engine"]
    loaded = top_level_after("\n".join(src))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "simglucose_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level_after(
        f"import sys\nsys.path.insert(0, {ROOT!r})\n"
        "import benchmark.reference.rollout, benchmark.reference.ppo, benchmark.reference.tables")
    assert not loaded & (FORBIDDEN | {"simglucose_tpu_torch"}), loaded


def test_a_run_refuses_a_process_that_loaded_jax_names(tiny_tree):
    """run.py compares whole top-level names: a module named like the JAX
    package stops the run, one merely beginning with its name does not."""
    fake = os.path.join(tiny_tree, "simglucose_tpu")
    os.makedirs(fake)
    open(os.path.join(fake, "__init__.py"), "w").close()
    src = "\n".join([f"import sys; sys.path.insert(0, {tiny_tree!r})",
                     "import simglucose_tpu", "from benchmark import run",
                     "run.run_cell('cohort.pid4096_1d', 3, 0.2, device='cpu',"
                     " look_for_cards=False)"])
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True, timeout=300,
                         cwd=tiny_tree)
    assert out.returncode == 4 and "simglucose_tpu" in out.stderr
    assert "correct" not in out.stdout
    res = drive(tiny_tree, "cohort.pid4096_1d", seconds=0.2)
    assert res["correct"] is True


def test_without_a_card_a_run_exits_with_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "cohort.pid4096_1d", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
