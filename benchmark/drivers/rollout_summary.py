"""Population study on the rollout kernel: ``ops/rollout.py::rollout`` over
a cohort (the 30 reference patients cycled), one fresh Philox key a call,
each call's per-patient summary (:mod:`benchmark.harness.summary`)
reduced on the card and copied to the host.

Workload keys: ``batch`` lanes, ``steps`` env steps a call, ``controller``
('pid' | 'bb'), ``autoreset``, ``random_init_bg``; ``check_calls`` calls
of the window sampled from the seed and ``check_lanes`` lanes of each
held to the reference on the host's CPU (``check_threads`` threads).
"""
from __future__ import annotations

import torch

from benchmark.harness import draws
from benchmark.harness.runner import Runner, free_cuda
from benchmark.harness.summary import bg_gap, lanes_off, summary
from benchmark.reference import rollout as ref
from benchmark.reference import tables as ref_tables


def program_config(conf: dict, wl: dict, tables):
    """The program's rollout config: the configuration's sensor and pump
    rows of the program's tables, the cell's controller and episode law."""
    from simglucose_tpu_torch.ops.rollout import config_for_sensor

    pump = tables.pump_record(conf["pump"])
    pid = conf["pid"]
    return config_for_sensor(
        conf["sensor"], n_steps=wl["steps"], controller=wl["controller"],
        autoreset=wl["autoreset"], random_init_bg=wl["random_init_bg"], pid_p=pid["P"],
        pid_i=pid["I"], pid_d=pid["D"], pid_target=pid["target"], bb_target=conf["bb_target"],
        **{k: float(pump[k]) for k in ("inc_basal", "min_basal", "max_basal", "inc_bolus",
                                       "min_bolus", "max_bolus")})


def reference_config(conf: dict, wl: dict) -> ref.Config:
    fields = ref.sensor_pump(ref_tables.by_name("sensor")[conf["sensor"]],
                             ref_tables.by_name("pump")[conf["pump"]])
    pid = conf["pid"]
    return ref.Config(n_steps=wl["steps"], controller=wl["controller"],
                      autoreset=wl["autoreset"], random_init_bg=wl["random_init_bg"],
                      pid_p=pid["P"], pid_i=pid["I"], pid_d=pid["D"], pid_target=pid["target"],
                      bb_target=conf["bb_target"], **fields)


def reference_summaries(conf: dict, wl: dict, names: list, calls: list,
                        dtype=torch.float32) -> torch.Tensor:
    """The reference's summaries ``[4, n]`` of ``calls``, a list of (key,
    lanes): every call's lanes under its own key, run as one batch on the
    CPU."""
    lanes = torch.cat([torch.as_tensor(ls, dtype=torch.int64) for _, ls in calls])
    k0 = torch.cat([torch.full((len(ls),), k[0], dtype=torch.int64) for k, ls in calls])
    k1 = torch.cat([torch.full((len(ls),), k[1], dtype=torch.int64) for k, ls in calls])
    pt = ref_tables.patients([names[i] for i in lanes.tolist()], "cpu", dtype)
    out, _ = ref.rollout(reference_config(conf, wl), pt, (k0, k1), lanes, dtype=dtype)
    return summary(out["BG"])


def numbers_of(got: torch.Tensor, want: torch.Tensor, n_steps: int) -> dict:
    """The share of compared lanes off the reference, and the median lane's
    relative gap of mean BG."""
    return {"lanes_off": float(lanes_off(got, want, n_steps).double().mean()),
            "bg_gap_median": float(bg_gap(got, want).median())}


def checked_calls(seed: int, wl: dict, keys: list) -> list:
    """(key, lanes) of the compared calls: each call's lanes drawn from the
    seed, in the order the calls are given."""
    pick = draws.rng(seed, "lanes")
    return [(k, sorted(pick.choice(wl["batch"], size=min(wl["check_lanes"], wl["batch"]),
                                   replace=False).tolist())) for k in keys]


def control(conf: dict, wl: dict, seed: int) -> dict:
    """The reference in bfloat16 put in the program's place, on the calls a
    run of ``seed`` would compare first."""
    keys = draws.CallKeys(seed)
    calls = checked_calls(seed, wl, [keys[i] for i in range(wl["check_calls"])])
    names = names_of(wl["batch"])
    want = reference_summaries(conf, wl, names, calls)
    got = reference_summaries(conf, wl, names, calls, dtype=torch.bfloat16)
    return numbers_of(got, want, wl["steps"])


def names_of(B: int) -> list:
    base = ref_tables.patient_names()
    return [base[i % len(base)] for i in range(B)]


class Rollouts(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        from simglucose_tpu_torch import params as tables
        from simglucose_tpu_torch.models.uva_padova import basal_rate
        from simglucose_tpu_torch.ops.rollout import pack_params, rollout

        wl, conf = ctx.workload, ctx.config
        self.B, self.T = wl["batch"], wl["steps"]
        self.work_per_call = self.B * self.T
        self.names = names_of(self.B)
        patient = tables.load_patient_params(self.names, device=self.device)
        quest = tables.load_quest_params(self.names, device=self.device)
        self.packed = pack_params(patient, basal_rate(patient), quest=quest)
        self.cfg = program_config(conf, wl, tables)
        self._rollout = rollout
        self.keys = draws.CallKeys(ctx.seed)
        self.sample = draws.Reservoir(ctx.seed, wl["check_calls"])
        self.kept = {}
        self.i = 0
        warm = draws.CallKeys(ctx.seed + 1)
        for j in range(2):  # the kernels' build and first launches
            self._summary(warm[j]).cpu()

    def _summary(self, key) -> torch.Tensor:
        return summary(self._rollout(self.cfg, self.packed, key)["BG"])

    def call(self):
        key = self.keys[self.i]
        s = self._summary(key).cpu()
        if not torch.isfinite(s).all():
            self.failed += 1
        if self.sample.offer(self.i):
            self.kept.pop(self.sample.evicted, None)
            self.kept[self.i] = (key, s)
        self.i += 1

    def check(self, rec):
        wl = self.ctx.workload
        self.packed = None
        free_cuda()
        torch.set_num_threads(wl["check_threads"])
        order = sorted(self.kept)
        calls = checked_calls(self.ctx.seed, wl, [self.kept[i][0] for i in order])
        got = torch.cat([self.kept[i][1][:, lanes] for i, (_, lanes) in zip(order, calls)], dim=1)
        want = reference_summaries(self.ctx.config, wl, self.names, calls)
        return self.numbers(numbers_of(got, want, self.T))


def setup(ctx):
    return Rollouts(ctx)
