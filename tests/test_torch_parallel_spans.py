"""The spans of ``parallel/sharding.py`` on two gloo ranks on the CPU.

One spawn of two ranks (a ``file://`` store under the test's temporary
directory, one torch thread a rank) runs every case and writes a JSON
file per rank, read by a module fixture:

* inside a ``torch.profiler`` session, ``simulate_cohort(mesh=)`` records
  one ``mesh.gather`` span an all-gather (the planes and the reset rows),
  each with a ``bytes`` counter equal to the gathered tensor's bytes, and
  one ``mesh.check_same``, all under the call's ``simulate_cohort`` span;
* ``simulate_cohort`` without a mesh records no ``mesh.*`` span;
* outside a session neither records anything;
* the results are the same bits with the spans on and off.

The ranks leave their group together (a barrier, then
``destroy_process_group``).
"""
import json
import os
import subprocess
import sys
import textwrap
from datetime import timedelta

import pytest
import torch

from simglucose_tpu_torch.sim import engine
from simglucose_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
SPAWN_TIMEOUT_S = 300
HOURS, PATIENTS = 2, 8
STEPS = HOURS * 60 // 3  # Dexcom's 3-minute samples
PADDED = 128 * N_RANKS  # the cohort padded to a 128-lane row a rank

WORKER = textwrap.dedent(
    """
    import json, os, sys
    from datetime import timedelta
    import numpy as np, torch
    rank, n, store, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from simglucose_tpu_torch.parallel.multihost import process_group
    with process_group(f"file://{store}", world_size=n, rank=rank, backend="gloo"):
        from simglucose_tpu_torch import params as tables
        from simglucose_tpu_torch.parallel.sharding import make_mesh
        from simglucose_tpu_torch.sim import engine
        from simglucose_tpu_torch.utils import profiling

        spec = json.load(open(os.path.join(workdir, "spec.json")))
        kw = dict(sim_time=timedelta(hours=spec["hours"]), scenario_seed=3, cgm_seed=4,
                  patient_names=tables.cohort_names(spec["patients"]), device="cpu")
        mesh = make_mesh()

        def recorded(fn, session):
            profiling.clear_spans()
            if session:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                    res = fn()
            else:
                res = fn()
            got = profiling.spans()
            names = [s.name for s in got]
            return res, [dict(name=s.name, counts=s.counts,
                              parent=names[s.parent] if s.parent >= 0 else None) for s in got]

        out = {}
        on, out["mesh_on"] = recorded(lambda: engine.simulate_cohort(**kw, mesh=mesh), True)
        _, out["alone_on"] = recorded(lambda: engine.simulate_cohort(**kw), True)
        off, out["mesh_off"] = recorded(lambda: engine.simulate_cohort(**kw, mesh=mesh), False)
        _, out["alone_off"] = recorded(lambda: engine.simulate_cohort(**kw), False)
        planes = lambda r: [*r.traj, r.reward, *r.reset]
        out["same_bits"] = all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
                               for a, b in zip(planes(on), planes(off)))
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parallel_spans"))
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({"hours": HOURS, "patients": PATIENTS}, f)
    store = os.path.join(d, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(N_RANKS), store, d],
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
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_spans(spans: list, name: str = None) -> list:
    return [s for s in spans if s["name"].startswith("mesh.") and name in (None, s["name"])]


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_gather_spans_count_the_gathered_bytes(ranks, rank):
    gathers = mesh_spans(ranks[rank]["mesh_on"], "mesh.gather")
    planes = 4 * STEPS * PADDED * 4  # BG, CGM, CHO, insulin, float32
    reset = 2 * PADDED * 4  # the reset row's BG and CGM
    assert [g["counts"] for g in gathers] == [{"bytes": planes}, {"bytes": reset}]
    assert all(g["parent"] == "simulate_cohort" for g in gathers)


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_one_check_same_span_a_call(ranks, rank):
    got = mesh_spans(ranks[rank]["mesh_on"], "mesh.check_same")
    assert len(got) == 1 and got[0]["parent"] == "cohort.prepare" and got[0]["counts"] == {}
    assert len(mesh_spans(ranks[rank]["mesh_on"])) == 3


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_one_process_records_no_mesh_span(ranks, rank):
    spans = ranks[rank]["alone_on"]
    assert "simulate_cohort" in [s["name"] for s in spans] and mesh_spans(spans) == []


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_nothing_is_recorded_outside_a_session(ranks, rank):
    assert ranks[rank]["mesh_off"] == [] and ranks[rank]["alone_off"] == []


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_spans_leave_the_result_bit_for_bit(ranks, rank):
    assert ranks[rank]["same_bits"] is True


def test_a_process_without_a_group_records_no_mesh_span():
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.simulate_cohort(sim_time=timedelta(hours=1), patient_names=["adult#001"],
                               scenario_seed=1, cgm_seed=2, device="cpu")
    names = [s.name for s in profiling.spans()]
    profiling.clear_spans()
    assert "simulate_cohort" in names and not [n for n in names if n.startswith("mesh.")]
