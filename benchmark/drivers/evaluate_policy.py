"""Evaluation of a trained insulin policy over a cohort:
``rl/evaluate.py::evaluate_policy_kernel`` over the 30 reference patients
cycled to ``batch`` lanes for ``hours``, the policy's mean action on K1b
through ``sim/engine.py::kernel_cohort``, a fresh evaluation seed a call,
then evaluation's host work (the planes' copy, their transposes and
``cohort_stats``).  The function's defaults apply: a start at 00:00, the
fixed initial state, no auto-reset.

The policy is the ``ppo`` configuration's relu 7-64-64, initialised from
the seed on the card as the fused cell's driver initialises it; the
reference takes a copy of those leaves (a generator on the card draws
other numbers than one on the CPU from the same seed).  ``check_calls``
calls of the window are kept as they complete (drawn from the seed), and
``check_lanes`` lanes of each, drawn from the seed, are held to the
reference (:mod:`benchmark.reference.rollout` with the ``'nn'``
controller and a standard deviation of exactly 0, so that its action is
the mean) run on the host's CPU (``check_threads`` threads): the BG
traces through their day's summary (:mod:`benchmark.harness.summary`),
and everything else evaluation returns for a lane (the statistics of
``cohort_stats``, the CGM trace and the mean insulin) against the same
values worked out from the reference's own traces
(:mod:`benchmark.reference.stats`).

Workload keys: ``batch``, ``hours``, ``check_calls``, ``check_lanes``,
``check_threads``.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers.fused_train import initial_policy
from benchmark.harness import draws
from benchmark.harness.runner import Runner, free_cuda
from benchmark.harness.summary import bg_gap, lanes_off, summary
from benchmark.reference import rollout as ref
from benchmark.reference import stats as ref_stats
from benchmark.reference import tables as ref_tables

# the values evaluation returns a lane that the check compares: the
# statistics, the mean insulin, the traces
PER_LANE = ref_stats.STATS + ("insulin_mean",)
TRACES = ("BG", "CGM")
# those whose relative gap a lane's largest gap is taken over
GAPS = ("BG_mean", "BG_min", "BG_max", "LBGI", "HBGI", "risk_index", "insulin_mean", "CGM")


def n_steps(conf: dict, wl: dict) -> int:
    return int(wl["hours"] * 60) // conf["sample_time"]


def names_of(B: int) -> list:
    base = ref_tables.patient_names()
    return [base[i % len(base)] for i in range(B)]


def reference_returned(conf: dict, wl: dict, policy: dict, calls: list,
                       dtype=torch.float32) -> dict:
    """What evaluation returns for ``calls``' lanes, worked out from the
    reference's own traces: ``BG`` and ``CGM`` ``[n, T]``, the statistics
    of its BG and its mean insulin ``[n]``, float64.  ``calls`` is a list
    of (evaluation seed, lanes), each call's lanes under the key (seed, 0),
    run as one batch on the CPU with ``policy``'s leaves acting by their
    mean: the log std set to minus infinity, so that the sampled action is
    the mean plus exactly 0."""
    lanes = torch.cat([torch.as_tensor(ls, dtype=torch.int64) for _, ls in calls])
    k0 = torch.cat([torch.full((len(ls),), s & 0xFFFFFFFF, dtype=torch.int64) for s, ls in calls])
    fields = ref.sensor_pump(ref_tables.by_name("sensor")[conf["sensor"]],
                             ref_tables.by_name("pump")[conf["pump"]])
    c = ref.Config(n_steps=n_steps(conf, wl), controller="nn", random_init_bg=False,
                   autoreset=False, fixed_start_min=0, action_scale=conf["action_scale"],
                   **fields)
    policy = {k: v.to("cpu", dtype) for k, v in policy.items()}
    policy["log_std"] = torch.full((1,), float("-inf"), dtype=dtype)
    pt = ref_tables.patients([names_of(wl["batch"])[i] for i in lanes.tolist()], "cpu", dtype)
    out, _ = ref.rollout(c, pt, (k0, torch.zeros_like(k0)), lanes, policy=policy, dtype=dtype)
    want = {k: v.numpy() for k, v in ref_stats.cohort_stats(out["BG"]).items()}
    want["insulin_mean"] = out["insulin"].double().mean(0).numpy()
    for k in TRACES:
        want[k] = out[k].double().T.numpy()
    return want


def returned_lanes(out: dict, lanes, B: int, T: int) -> dict:
    """The program's returned values of ``lanes`` in float64; a value of
    another shape than evaluation documents (``[B]``, the traces ``[B,
    T]``) reads as NaN, that is, off."""
    got = {}
    for k in PER_LANE + TRACES:
        shape = (B, T) if k in TRACES else (B,)
        v = np.asarray(out.get(k, np.nan), dtype=np.float64)
        got[k] = v[lanes] if v.shape == shape else np.full((len(lanes),) + shape[1:], np.nan)
    return got


def tolerance(T: int) -> dict:
    """How far each returned value may stand from the reference's, as
    :func:`benchmark.harness.summary.lanes_off` holds a day's summary: BG's
    mean, least and largest to 0.01 mg/dL plus a relative 1e-3 (an
    untrained policy drives some patients to a BG of about 0, where a
    relative gap means nothing); the CGM trace sample by sample (clipped
    at 39 mg/dL) and the mean insulin to a relative 1e-3; the zone shares
    (percent) by two steps of the day; the risk indices to 0.01 plus a
    relative 1e-3.  A lane whose values carry only the rounding of another
    order of operations stays well inside; one whose closed loop took
    another course does not.  ``(absolute, relative)`` a value."""
    risk, bg, rel = (0.01, 1e-3), (0.01, 1e-3), (0.0, 1e-3)
    tol = {k: (100.0 * 2.0 / T + 1e-9, 0.0) for k in ref_stats.STATS if k.startswith("percent_")}
    tol.update(BG_mean=bg, BG_min=bg, BG_max=bg, insulin_mean=rel, CGM=rel, LBGI=risk,
               HBGI=risk, risk_index=risk)
    return tol


def _rel_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each lane's largest relative gap (0 where both are 0, infinite
    where ``got`` is not finite)."""
    d = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.nan_to_num(np.where(d == 0, 0.0, d / np.abs(want)), nan=np.inf)
    return r if r.ndim == 1 else r.max(axis=1)


def numbers_of(got: dict, want: dict, T: int) -> dict:
    """``lanes_off`` and ``bg_gap_median`` of the BG traces' summaries;
    ``stats_off``, the share of lanes with a returned value off by
    :func:`tolerance` (or not finite), and ``stats_gap_median``, the
    median lane's largest relative gap over :data:`GAPS`."""
    g = summary(torch.as_tensor(got["BG"].T))
    w = summary(torch.as_tensor(want["BG"].T))
    off = np.zeros(len(got["BG"]), dtype=bool)
    for k, (a, r) in tolerance(T).items():
        bad = ~(np.abs(got[k] - want[k]) <= a + r * np.abs(want[k]))
        off |= bad if bad.ndim == 1 else bad.any(axis=1)
    gap = np.max([_rel_gap(got[k], want[k]) for k in GAPS], axis=0)
    return {"lanes_off": float(lanes_off(g, w, T).double().mean()),
            "bg_gap_median": float(bg_gap(g, w).median()),
            "stats_off": float(off.mean()), "stats_gap_median": float(np.median(gap))}


def checked_calls(seed: int, wl: dict, seeds: list) -> list:
    """(evaluation seed, lanes) of the compared calls, the lanes drawn from
    the run's seed."""
    pick = draws.rng(seed, "lanes")
    return [(s, sorted(pick.choice(wl["batch"], size=min(wl["check_lanes"], wl["batch"]),
                                   replace=False).tolist())) for s in seeds]


def control(conf: dict, wl: dict, seed: int) -> dict:
    """The reference in bfloat16 put in the program's place, on the calls
    a run of ``seed`` would compare first."""
    keys = draws.CallKeys(seed)
    calls = checked_calls(seed, wl, [keys[i][0] for i in range(wl["check_calls"])])
    policy = initial_policy(conf, seed, "cpu")
    want = reference_returned(conf, wl, policy, calls)
    got = reference_returned(conf, wl, policy, calls, dtype=torch.bfloat16)
    return numbers_of(got, want, n_steps(conf, wl))


class PolicyEvaluations(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        from simglucose_tpu_torch.params import cohort_names
        from simglucose_tpu_torch.rl.evaluate import evaluate_policy_kernel
        from simglucose_tpu_torch.rl.policy import PolicyParams

        wl, conf = ctx.workload, ctx.config
        self.B, self.T = wl["batch"], n_steps(conf, wl)
        self.work_per_call = self.B * self.T
        leaves = initial_policy(conf, ctx.seed, self.device)
        self.policy = {k: v.cpu() for k, v in leaves.items()}  # the reference's copy of them
        self.params = PolicyParams(**leaves, act=conf["act"], action_scale=conf["action_scale"],
                                   decoder="sigmoid")
        self.names = cohort_names(self.B)
        self._evaluate = evaluate_policy_kernel
        self.keys = draws.CallKeys(ctx.seed)
        self.sample = draws.Reservoir(ctx.seed, wl["check_calls"])
        self.kept, self.i = {}, 0
        warm = draws.CallKeys(ctx.seed + 1)
        for j in range(2):  # the kernel's build and first launches
            self._run(warm[j][0])

    def _run(self, seed: int) -> dict:
        """One evaluation at ``seed``: its statistics and ``[B, T]`` traces,
        the dict evaluation returns."""
        return self._evaluate(self.params, self.names, hours=self.ctx.workload["hours"],
                              seed=seed, device=self.device)

    def call(self):
        seed = self.keys[self.i][0]
        out = self._run(seed)
        if not np.isfinite(out["BG_mean"]).all():  # NaN wherever a lane's BG is
            self.failed += 1
        if self.sample.offer(self.i):
            self.kept.pop(self.sample.evicted, None)
            self.kept[self.i] = (seed, out)
        self.i += 1

    def check(self, rec):
        wl, conf = self.ctx.workload, self.ctx.config
        self.params = None
        free_cuda()
        torch.set_num_threads(wl["check_threads"])
        order = sorted(self.kept)
        calls = checked_calls(self.ctx.seed, wl, [self.kept[i][0] for i in order])
        each = [returned_lanes(self.kept[i][1], lanes, self.B, self.T)
                for i, (_, lanes) in zip(order, calls)]
        got = {k: np.concatenate([e[k] for e in each]) for k in each[0]}
        want = reference_returned(conf, wl, self.policy, calls)
        return self.numbers(numbers_of(got, want, self.T))


def setup(ctx):
    return PolicyEvaluations(ctx)
