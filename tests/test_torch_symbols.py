"""``simglucose_tpu_torch/SYMBOLS.md`` maps every public name of the JAX
side to the port: each top-level public ``def`` / ``class`` of
``simglucose_tpu/**.py``, ``tools/*.py``, ``examples/*.py``, ``bench.py``
and ``__graft_entry__.py`` (found with ``ast``, no JAX import) has a row
in its file's section, and each example a ``(script)`` row.  A row names a
port counterpart ``file::name`` that exists (the module imports and has
the name) or says "not ported" with a reason; none says "not ported yet".
The map must not call the random scenario "harris-benedict"."""
import ast
import glob
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMBOLS = os.path.join(ROOT, "simglucose_tpu_torch", "SYMBOLS.md")


def _jax_files():
    files = sorted(glob.glob(os.path.join(ROOT, "simglucose_tpu", "**", "*.py"), recursive=True))
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "*.py")))
    files += sorted(glob.glob(os.path.join(ROOT, "examples", "*.py")))
    files += [os.path.join(ROOT, "bench.py"), os.path.join(ROOT, "__graft_entry__.py")]
    return [os.path.relpath(f, ROOT) for f in files]


def _public_names(rel):
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _sections():
    """{JAX file: {name: port cell}} from the map."""
    out, cur = {}, None
    for line in open(SYMBOLS):
        m = re.match(r"^### `([^`]+)`$", line.strip())
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"^\| (`[^`]+`|\(script\)) \| (.+?) \| (.*)\|$", line.strip())
        if m and cur is not None:
            cur[m.group(1).strip("`")] = m.group(2).strip()
    return out


def test_every_public_jax_name_has_a_row():
    sections = _sections()
    missing = []
    for rel in _jax_files():
        names = _public_names(rel) + (["(script)"] if rel.startswith("examples") else [])
        missing += [f"{rel}::{n}" for n in names if n not in sections.get(rel, {})]
    assert not missing, missing
    assert sum(len(v) for v in sections.values()) >= 222


def _port_targets():
    for rel, rows in _sections().items():
        for name, cell in rows.items():
            yield rel, name, cell


def test_every_row_resolves():
    bad = []
    for rel, name, cell in _port_targets():
        if cell.startswith("not ported"):
            if len(cell.split(":", 1)[-1].strip()) < 10:
                bad.append((rel, name, "no reason"))
            continue
        m = re.fullmatch(r"`(simglucose_tpu_torch/[\w/]+\.py)::(\w+)`", cell)
        if not m:
            bad.append((rel, name, cell))
            continue
        mod = m.group(1)[:-3].replace("/", ".").removesuffix(".__init__")
        if not hasattr(importlib.import_module(mod), m.group(2)):
            bad.append((rel, name, cell))
    assert not bad, bad


def test_nothing_is_left_to_port():
    rows = list(_port_targets())
    assert not [(rel, name) for rel, name, cell in rows if "not ported yet" in cell]
    assert {"bench.py", "__graft_entry__.py"} <= {rel for rel, _, _ in rows}


def test_no_harris_benedict():
    text = open(SYMBOLS).read()
    assert "truncated-normal meal slots" in text
    assert not re.search(r"harris-benedict[^\"]", text.replace('"harris-benedict"', ""))


@pytest.mark.parametrize("name", ["ppo_grad_step_gather2", "make_pallas_rollout", "main",
                                  "bench_pallas"])
def test_kernel_and_tool_rows(name):
    rows = {(rel, n): c for rel, n, c in _port_targets()}
    want = {
        "ppo_grad_step_gather2": (("simglucose_tpu/ops/pallas_ppo_learner.py", name),
                                  "`simglucose_tpu_torch/ops/ppo_learner.py::ppo_grad_step_gather2`"),
        "make_pallas_rollout": (("simglucose_tpu/ops/pallas_rollout.py", name),
                                "`simglucose_tpu_torch/ops/rollout.py::rollout`"),
        "main": (("tools/train_ppo_tpu.py", name),
                 "`simglucose_tpu_torch/tools/train_ppo.py::main`"),
        "bench_pallas": (("bench.py", name),
                         "`simglucose_tpu_torch/tools/bench.py::bench_pallas`"),
    }[name]
    assert rows[want[0]] == want[1]


@pytest.mark.parametrize("name", ["_HwRng", "_SwRng"])
def test_tpu_generators_have_a_decision(name):
    """Each of the TPU kernel's two random streams has a row saying why
    the port does without it (the port draws Philox-4x32-10)."""
    rows = {(rel, n): c for rel, n, c in _port_targets()}
    cell = rows[("simglucose_tpu/ops/pallas_rollout.py", name)]
    assert cell.startswith("not ported: ") and len(cell) > 40
