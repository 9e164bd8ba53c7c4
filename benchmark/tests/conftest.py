"""Fixtures of the benchmark's CPU tests.

``tiny_tree`` is a copy of the benchmark beside the program, with every
cell cut to a size the CPU runs in seconds; ``drive`` runs one cell there
in a fresh interpreter, optionally with the program broken underneath
first, and returns the result line.  Tests that need the card carry the
``card`` marker and ask for the ``card`` fixture, which skips where no
CUDA device is visible (decided when the test runs, never at import).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# each cell at a CPU size: the program's plain versions run it in seconds
TINY = {
    "cohort.pid4096_1d": dict(batch=128, steps=16, check_lanes=32, check_threads=1),
    "cohort.ref30_1d": dict(patients=6, hours=2, check_threads=1),
    "ppo.fused8192_t64": dict(batch=256, rollout_steps=8),
}
TINY_CONFIG = {"ppo": dict(hidden=16)}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def make_tree(dst: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``dst`` beside a link
    to the program, every cell cut to its TINY size."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    pkg = "simglucose_tpu_torch"
    os.symlink(os.path.join(ROOT, pkg), os.path.join(dst, pkg))
    for name, cut in TINY.items():
        _update(os.path.join(dst, "benchmark", "workloads", f"{name}.json"), cut)
    for name, cut in TINY_CONFIG.items():
        _update(os.path.join(dst, "benchmark", "configs", f"{name}.json"), cut)
    return dst


def _update(path: str, cut: dict):
    with open(path) as f:
        d = json.load(f)
    d.update(cut)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tree(str(tmp_path))


def drive(tree: str, cell: str, seed: int = 2 ** 33 + 5, seconds: float = 0.5,
          patch: str = "", timeout: float = 300) -> dict:
    """One run of ``cell`` in ``tree`` on the CPU, in a fresh interpreter,
    after ``patch`` (Python source run first); returns the result line."""
    src = "\n".join([
        "import json, sys", f"sys.path.insert(0, {tree!r})", "import torch",
        textwrap.dedent(patch),
        "from benchmark import run",
        f"res = run.run_cell({cell!r}, {seed}, {seconds}, device='cpu', look_for_cards=False)",
        "print(json.dumps(res))"])
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=tree)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
