"""A population study over a node's cards: ``sim/engine.py::simulate_cohort``
with ``mesh=make_mesh()`` on every rank, one process a card, as the
port's multi-card users run it.  Rank 0 is the run's own process; the
other ranks are workers it spawns (:mod:`benchmark.harness.ranks`).  Each
call is one closed-loop day of the whole cohort with a fresh (scenario
seed, CGM seed) pair of the seed's keys, the same on every rank: rank 0
tells the workers to make the call and makes it itself, so the calls of
all ranks run together, back to back.  Every rank returns the whole
``CohortResult``.

Workload keys: ``patients`` (a count of the 30 cycled), ``hours``,
``controller``; ``check_calls`` calls of the window sampled from the seed
(:class:`draws.Reservoir`, whose offers rank 0 passes on), and on each of
them ``check_lanes`` global lanes drawn from the seed, the same number
from each rank's shard, always with each shard's first and last real
lane.  Every rank keeps those lanes of every plane (indexed out, a few
hundred of the cohort's lanes).  After the window the numbers compared:

* ``lanes_off``, ``bg_gap_median``: rank 0's planes against the plain
  reference on the host's CPU (``check_threads`` threads), as
  ``drivers/simulate.py`` compares them;
* ``ranks_apart``: the share of (worker, kept call) pairs whose lanes
  differ in any bit from rank 0's;
* ``single_apart``: the share of kept calls whose lanes on rank 0 differ
  in any bit from one process's ``simulate_cohort(mesh=None)`` of the same
  cohort and key, run on rank 0's card after the window.

A workload's ``fault`` key (one of :data:`FAULTS`) plants a fault in
every call; :func:`fault` reads each of them at once for calibration.
"""
from __future__ import annotations

import contextlib
import os
import types
from datetime import timedelta

import numpy as np
import torch

from benchmark.drivers.simulate import PLANES, names_of, numbers_of, reference_planes
from benchmark.harness import draws, ranks
from benchmark.harness.runner import Runner, free_cuda

FIELDS = ("BG", "CGM", "CHO", "insulin", "LBGI", "HBGI", "risk")  # CohortResult's planes
# the faults a workload (or calibration) can plant: rank 0's lane offset
# shifted by one shard; the gathered shards in reverse rank order; no
# exchange (each rank's own shard tiled); rank 1's result altered by one
# ulp on the first kept lane
FAULTS = ("lane_offset", "gather_order", "no_exchange", "one_ulp")


def padded_lanes(patients: int, n_ranks: int) -> int:
    """The cohort padded to whole 128-lane rows on every rank, as
    ``_simulate_kernel`` pads it."""
    from simglucose_tpu_torch.ops.rollout import LANES

    unit = LANES * n_ranks
    return -(-patients // unit) * unit


def check_lanes(seed: int, wl: dict, n_ranks: int) -> np.ndarray:
    """The global lanes compared, ascending: ``check_lanes / n_ranks`` of
    each rank's shard (fewer where it holds fewer real lanes), its first and
    last real lane among them, the rest drawn from the seed."""
    B = wl["patients"]
    per = padded_lanes(B, n_ranks) // n_ranks
    k = wl["check_lanes"] // n_ranks
    pick = draws.rng(seed, "check_lanes")
    out = []
    for r in range(n_ranks):
        lo, hi = r * per, min((r + 1) * per, B)
        if hi <= lo:
            continue
        ends = sorted({lo, hi - 1})
        inner = np.arange(lo + 1, hi - 1)
        n = min(max(k - len(ends), 0), len(inner))
        out += ends + pick.choice(inner, size=n, replace=False).tolist()
    return np.array(sorted(out), dtype=np.int64)


def kept_planes(res, lanes: np.ndarray) -> dict:
    """``lanes`` of every plane of a ``CohortResult``: the seven ``[T, L]``
    fields and the reward, and the reset row's seven ``[L]`` fields."""
    out = {f: np.ascontiguousarray(getattr(res.traj, f)[:, lanes]) for f in FIELDS}
    out["reward"] = np.ascontiguousarray(res.reward[:, lanes])
    out.update({f"reset_{f}": np.ascontiguousarray(getattr(res.reset, f)[lanes]) for f in FIELDS})
    return out


def same_bits(a: dict, b: dict) -> bool:
    return a is not None and b is not None and set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)


def as_reference(kept: list) -> dict:
    """Kept planes of several calls, lanes concatenated in order, under the
    names :func:`drivers.simulate.numbers_of` compares."""
    cat = lambda k: torch.from_numpy(np.concatenate([p[k] for p in kept], axis=-1))
    out = {k: cat(f) for k, f in zip(PLANES, FIELDS + ("reward",))}
    out["BG0"], out["CGM0"] = cat("reset_BG"), cat("reset_CGM")
    return out


@contextlib.contextmanager
def planted(fault, rank: int):
    """The program with ``fault`` planted on this rank for the block."""
    from simglucose_tpu_torch.ops.rollout import NP_PLANES
    from simglucose_tpu_torch.sim import engine

    saved = {k: getattr(engine, k) for k in ("rollout", "gather_lanes")}
    if fault == "lane_offset" and rank == 0:
        def rollout(cfg, packed, *a, lane_offset=0, **k):
            shard = packed.numel() // NP_PLANES
            return saved["rollout"](cfg, packed, *a, lane_offset=lane_offset + shard, **k)

        engine.rollout = rollout
    elif fault == "gather_order":
        def gather_lanes(t, mesh, axis=-1):
            parts = saved["gather_lanes"](t, mesh, axis).chunk(mesh.dp, dim=axis)
            return torch.cat(parts[::-1], dim=axis)

        engine.gather_lanes = gather_lanes
    elif fault == "no_exchange":
        engine.gather_lanes = lambda t, mesh, axis=-1: torch.cat([t] * mesh.dp, dim=axis)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(engine, k, v)


class Cohort:
    """One rank's calls of the program over the whole cohort."""

    def __init__(self, wl: dict, conf: dict, device, rank: int, lanes: np.ndarray):
        from simglucose_tpu_torch.parallel.sharding import make_mesh
        from simglucose_tpu_torch.sim import engine

        self.engine, self.mesh, self.rank, self.lanes = engine, make_mesh(), rank, lanes
        self.device = torch.device(device)
        self.names = names_of(wl)
        self.kw = dict(sim_time=timedelta(hours=wl["hours"]), scenario=None,
                       controller=(wl["controller"], {"target": conf["bb_target"]}),
                       patient_names=self.names, cgm_name=conf["sensor"],
                       insulin_pump_name=conf["pump"])

    def run(self, key, fault=None, alone: bool = False):
        """The call keyed by ``key`` over the mesh (``alone``: this process
        by itself, no mesh)."""
        with planted(fault, self.rank):
            res = self.engine.simulate_cohort(
                **self.kw, scenario_seed=key[0], cgm_seed=key[1], device=self.device,
                mesh=None if alone else self.mesh)
        if fault == "one_ulp" and self.rank == 1:
            bg, lane = res.traj.BG, self.lanes[0]
            bg[0, lane] = np.nextafter(bg[0, lane], np.float32(np.inf))
        return res


class Worker:
    """A worker rank (:mod:`benchmark.harness.ranks`): ``("call", key, keep,
    evict, fault)`` makes the call and keeps its lanes under ``keep``
    (dropping ``evict``); :meth:`stop` returns what it kept."""

    def __init__(self, rank: int, n: int, args: dict):
        self.cohort = Cohort(args["wl"], args["conf"], args["device"], rank, args["lanes"])
        self.kept = {}

    def handle(self, msg):
        _, key, keep, evict, fault = msg
        res = self.cohort.run(key, fault)
        if keep is not None:
            self.kept.pop(evict, None)
            self.kept[keep] = kept_planes(res, self.cohort.lanes)

    def stop(self) -> dict:
        return self.kept


class CohortRanks(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        wl, conf = ctx.workload, ctx.config
        self.names = names_of(wl)
        self.work_per_call = len(self.names) * (wl["hours"] * 60 // conf["sample_time"])
        self.lanes = check_lanes(ctx.seed, wl, ctx.chips)
        self.fault = wl.get("fault")
        if self.fault is not None and self.fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}; got {self.fault!r}")
        if self.device.type == "cuda":  # built once here, not by every rank at once
            from simglucose_tpu_torch.ops.build import load_library

            load_library()
        self.ranks = ranks.Ranks(ctx.chips, os.path.abspath(__file__),
                                 dict(wl=wl, conf=conf, lanes=self.lanes,
                                      device=self.device.type))
        try:
            self.me = Cohort(wl, conf, self.device, 0, self.lanes)
            self.keys = draws.CallKeys(ctx.seed)
            self.sample = draws.Reservoir(ctx.seed, wl["check_calls"])
            self.kept = {}  # tag -> (key, kept planes)
            self.alone, self.want = {}, {}  # by key: one process's lanes; the reference's
            self.i = 0
            warm = draws.CallKeys(ctx.seed + 1)
            for j in range(2):
                self._call(warm[j])
        except BaseException:
            self.ranks.close()
            raise

    def _call(self, key, keep=None, evict=None, fault=None):
        """One call on every rank; rank 0's result, its lanes kept under
        ``keep``."""
        with self.ranks.waiting():
            self.ranks.tell(("call", key, keep, evict, fault))
            res = self.me.run(key, fault)
        if keep is not None:
            self.kept.pop(evict, None)
            self.kept[keep] = (key, kept_planes(res, self.lanes))
        return res

    def call(self):
        key = self.keys[self.i]
        keep = self.i if self.sample.offer(self.i) else None
        res = self._call(key, keep, self.sample.evicted, self.fault)
        if not np.isfinite(res.traj.BG).all():
            self.failed += 1
        self.i += 1

    def compare(self, tags: list, theirs: list) -> dict:
        """The four numbers over the kept calls ``tags`` (``theirs``: each
        worker's kept planes by tag), once the ranks have stopped."""
        keys = [self.kept[t][0] for t in tags]
        mine = [self.kept[t][1] for t in tags]
        for key in keys:
            if key not in self.alone:
                self.alone[key] = kept_planes(self.me.run(key, alone=True), self.lanes)
        want = self._reference(keys)
        out = numbers_of(self.ctx.config, as_reference(mine), want)
        apart = [not same_bits(w.get(t), p) for w in theirs for t, p in zip(tags, mine)]
        out["ranks_apart"] = float(np.mean(apart)) if apart else 1.0
        out["single_apart"] = float(np.mean([not same_bits(self.alone[k], p)
                                             for k, p in zip(keys, mine)]))
        return out

    def _reference(self, keys: list) -> dict:
        if tuple(keys) not in self.want:
            free_cuda()
            torch.set_num_threads(self.ctx.workload["check_threads"])
            self.want[tuple(keys)] = reference_planes(self.ctx.config, self.ctx.workload,
                                                      self.names, keys, lanes=self.lanes.tolist())
        return self.want[tuple(keys)]

    def check(self, rec):
        theirs = self.ranks.stop()
        return self.numbers(self.compare(sorted(self.kept), theirs))


def setup(ctx):
    return CohortRanks(ctx)


def control(conf: dict, wl: dict, seed: int) -> dict:
    """The reference in bfloat16 put in the program's place, on the lanes
    and calls a run of ``seed`` would compare first."""
    keys = draws.CallKeys(seed)
    keys = [keys[i] for i in range(wl["check_calls"])]
    lanes = check_lanes(seed, wl, conf["assumed"]["ranks"]).tolist()
    names = names_of(wl)
    want = reference_planes(conf, wl, names, keys, lanes=lanes)
    got = reference_planes(conf, wl, names, keys, lanes=lanes, dtype=torch.bfloat16)
    return numbers_of(conf, {k: v.float() for k, v in got.items()}, want)


def fault(conf: dict, wl: dict, seed: int) -> dict:
    """Each planted fault's numbers, by fault: one deployment of the ranks
    makes the first ``check_calls`` calls of ``seed`` under each fault in
    turn, and every call is compared."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = types.SimpleNamespace(seed=seed, workload=wl, config=conf,
                                chips=conf["assumed"]["ranks"], trace=False, device=device)
    runner = CohortRanks(ctx)
    keys = [runner.keys[i] for i in range(wl["check_calls"])]
    try:
        for f in FAULTS:
            for i, key in enumerate(keys):
                runner._call(key, (f, i), None, f)
        theirs = runner.ranks.stop()
    finally:
        runner.ranks.close()
    return {f: runner.compare([(f, i) for i in range(len(keys))], theirs) for f in FAULTS}
