"""A clinician's simulation: ``sim/engine.py::simulate`` over the named
patients with no ``save_path``, one caller waiting for each result, every
call with a fresh (scenario seed, CGM seed) pair; the result is the
(patient, Time) results frame (BG, CGM, CHO, insulin, LBGI, HBGI, Risk;
the reset row first) with the rewards in ``df.attrs['reward']``.

Workload keys: ``patients`` (names, or a count of the 30 cycled),
``hours``, ``controller`` ('BB' | 'PID'); ``check_calls`` calls of the
window sampled from the seed are held, whole, to the reference on the
host's CPU (``check_threads`` threads).
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from benchmark.harness import draws
from benchmark.harness.runner import Runner, free_cuda
from benchmark.reference import rollout as ref
from benchmark.reference import tables as ref_tables

PLANES = ("BG", "CGM", "CHO", "insulin", "LBGI", "HBGI", "risk", "reward")


def names_of(wl: dict) -> list:
    pts = wl["patients"]
    if isinstance(pts, int):
        base = ref_tables.patient_names()
        return [base[i % len(base)] for i in range(pts)]
    return list(pts)


def risk_planes(bg: torch.Tensor) -> tuple:
    """(LBGI, HBGI, risk) of single BG samples (simglucose's risk_index of
    one sample)."""
    f = 1.509 * (torch.pow(torch.log(torch.clamp(bg, min=1.0)), 1.084) - 5.381)
    r = 10.0 * f * f
    lo, hi = torch.where(f < 0, r, 0.0), torch.where(f > 0, r, 0.0)
    return lo, hi, lo + hi


def reference_planes(conf: dict, wl: dict, names: list, keys: list, lanes: list = None,
                     dtype=torch.float32) -> dict:
    """The reference's ``[T, n * L]`` planes and ``[n * L]`` reset rows of
    the ``n`` calls keyed by ``keys``, at the cohort's ``lanes`` (default
    all; one list, or one a call), all in one batch: the closed loop from
    midnight without auto-reset, the risk planes of BG, and the
    risk-difference reward replayed from CGM (the reset CGM before the
    first step)."""
    if lanes is None:
        lanes = list(range(len(names)))
    per_call = lanes if lanes and isinstance(lanes[0], list) else [lanes] * len(keys)
    sizes = [len(ls) for ls in per_call]
    lanes = torch.tensor([i for ls in per_call for i in ls], dtype=torch.int64)
    per = lambda j: torch.tensor([k[j] for k in keys], dtype=torch.int64).repeat_interleave(
        torch.tensor(sizes))
    k0, k1 = per(0), per(1)
    fields = ref.sensor_pump(ref_tables.by_name("sensor")[conf["sensor"]],
                             ref_tables.by_name("pump")[conf["pump"]])
    c = ref.Config(n_steps=wl["hours"] * 60 // fields["sample_time"],
                   controller=wl["controller"].lower(), autoreset=False, random_init_bg=False,
                   fixed_start_min=0, bb_target=conf["bb_target"], **fields)
    out, _ = ref.rollout(c, ref_tables.patients([names[i] for i in lanes.tolist()], "cpu", dtype),
                         (k0, k1), lanes, dtype=dtype)
    planes = {k: out[k] for k in ("BG", "CGM", "CHO", "insulin")}
    planes["LBGI"], planes["HBGI"], planes["risk"] = risk_planes(out["BG"])
    prev = torch.cat([out["CGM0"][None], out["CGM"][:-1]])
    planes["reward"] = risk_planes(prev)[2] - risk_planes(out["CGM"])[2]
    planes["BG0"], planes["CGM0"] = out["BG0"], out["CGM0"]
    return planes


def program_planes(df, n_patients: int) -> dict:
    """A results frame's columns as ``[T, B]`` planes under :data:`PLANES`'
    names, and the reset row's BG and CGM."""
    out = {}
    for k, col in zip(PLANES[:7], ("BG", "CGM", "CHO", "insulin", "LBGI", "HBGI", "Risk")):
        rows = torch.tensor(df[col].to_numpy()).reshape(n_patients, -1)
        out[k] = rows[:, 1:].T.contiguous()
        if k in ("BG", "CGM"):
            out[k + "0"] = rows[:, 0].clone()
    out["reward"] = torch.from_numpy(np.asarray(df.attrs["reward"]))
    return out


def lanes_off(got: dict, want: dict, inc: float) -> torch.Tensor:
    """``[n]`` bool: the patient-calls where a plane leaves the reference's
    by more than rounding: BG, CGM and the reset row by a thousandth, the
    dose by one pump increment, the meals by a millionth, the risk planes
    and the reward by 0.01 plus a thousandth."""
    bad = torch.zeros(want["BG"].shape[-1], dtype=torch.bool)
    for k, rel, abs_ in (("BG", 1e-3, 0.0), ("CGM", 1e-3, 0.0), ("CHO", 1e-6, 0.0),
                         ("insulin", 1e-6, 1.001 * inc), ("LBGI", 1e-3, 0.01),
                         ("HBGI", 1e-3, 0.01), ("risk", 1e-3, 0.01), ("reward", 1e-3, 0.01),
                         ("BG0", 1e-3, 0.0), ("CGM0", 1e-3, 0.0)):
        g, w = got[k].double(), want[k].double()
        off = ((g - w).abs() > rel * w.abs() + abs_) | ~torch.isfinite(g)
        bad |= off.reshape(-1, off.shape[-1]).any(0)
    return bad


def numbers_of(conf: dict, got: dict, want: dict) -> dict:
    """The share of patient-calls off the reference, and the median
    patient-call's largest relative gap of BG over the day."""
    inc = ref_tables.by_name("pump")[conf["pump"]]["inc_bolus"] / 6000.0
    gap = ((got["BG"].double() - want["BG"].double()).abs() / want["BG"].double()).amax(0)
    return {"lanes_off": float(lanes_off(got, want, inc).double().mean()),
            "bg_gap_median": float(gap.median())}


def control(conf: dict, wl: dict, seed: int) -> dict:
    """The reference in bfloat16 put in the program's place, on the calls a
    run of ``seed`` would compare first."""
    keys = draws.CallKeys(seed)
    keys = [keys[i] for i in range(wl["check_calls"])]
    names = names_of(wl)
    want = reference_planes(conf, wl, names, keys)
    got = reference_planes(conf, wl, names, keys, dtype=torch.bfloat16)
    return numbers_of(conf, {k: v.float() for k, v in got.items()}, want)


class Simulations(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        from simglucose_tpu_torch.sim.engine import simulate

        wl, conf = ctx.workload, ctx.config
        self.names = names_of(wl)
        self.hours = wl["hours"]
        self.work_per_call = len(self.names) * (self.hours * 60 // conf["sample_time"])
        self._simulate = simulate
        self.keys = draws.CallKeys(ctx.seed)
        self.sample = draws.Reservoir(ctx.seed, wl["check_calls"])
        self.kept = {}
        self.i = 0
        warm = draws.CallKeys(ctx.seed + 1)
        for j in range(2):
            self._run(warm[j])

    def _run(self, key):
        conf = self.ctx.config
        return self._simulate(
            sim_time=timedelta(hours=self.hours), scenario=None, scenario_seed=key[0],
            controller=(self.ctx.workload["controller"], {"target": conf["bb_target"]}),
            patient_names=self.names, cgm_name=conf["sensor"], cgm_seed=key[1],
            insulin_pump_name=conf["pump"], device=self.device)

    def call(self):
        key = self.keys[self.i]
        df = self._run(key)
        if not np.isfinite(df["BG"].to_numpy()).all():
            self.failed += 1
        if self.sample.offer(self.i):
            self.kept.pop(self.sample.evicted, None)
            self.kept[self.i] = (key, program_planes(df, len(self.names)))
        self.i += 1

    def check(self, rec):
        free_cuda()
        torch.set_num_threads(self.ctx.workload["check_threads"])
        order = sorted(self.kept)
        keys = [self.kept[i][0] for i in order]
        want = reference_planes(self.ctx.config, self.ctx.workload, self.names, keys)
        got = {k: torch.cat([self.kept[i][1][k] for i in order], dim=-1) for k in want}
        return self.numbers(numbers_of(self.ctx.config, got, want))


def setup(ctx):
    return Simulations(ctx)
