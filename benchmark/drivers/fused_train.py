"""An RL researcher's training run: ``rl/fused.py::make_fused_train_loop``
on the ``kernel_prep`` path, each call ``iters_per_call`` iterations
continuing the last call's state, its metrics copied to the host.

Set-up builds the one training state from the seed (the policy's weights
drawn on the card, Adam's state zero, a CPU generator for the rollout keys
and the shuffle permutations) and drives it through its first
``check_steps`` iterations with the window's own call: they build and warm
every kernel, and the reference follows them from the seed.

The window's calls are held to the reference too: ``window_checks`` of
them, drawn from the seed as they complete, keep the state each started
from (params, Adam's state, the simulator's state planes, the generator)
and what each left.  After the window the reference follows each of them
from that state.  It can only start there: thousands of iterations
separate a window call from the seed.

Workload keys: ``batch``, ``rollout_steps``, ``iters_per_call``,
``check_steps``, ``window_checks``.  The configuration gives the policy
and the learner.
"""
from __future__ import annotations

import math

import torch

from benchmark.harness import draws
from benchmark.harness.runner import Runner, free_cuda
from benchmark.reference import ppo as ref_ppo
from benchmark.reference import rollout as ref
from benchmark.reference import tables as ref_tables

METRICS = ("pg_loss", "v_loss", "entropy")


def initial_policy(conf: dict, seed: int, device) -> dict:
    """He-initialised leaves drawn in one call on ``device`` from the seed."""
    H = conf["hidden"]
    gen = torch.Generator(device=device).manual_seed(draws.seed64(seed, "policy"))
    z = torch.randn(7 * H + H * H + 2 * H, generator=gen, device=device)
    w1, w2, w_mu, w_v = torch.split(z, [7 * H, H * H, H, H])
    full = lambda n, v: torch.full((n,), float(v), device=device)
    return {"w1": w1.view(7, H) * math.sqrt(2.0 / 7), "b1": full(H, 0.0),
            "w2": w2.view(H, H) * math.sqrt(2.0 / H), "b2": full(H, 0.0),
            "w_mu": w_mu.view(H, 1) * (math.sqrt(2.0 / H) * 0.01),
            "b_mu": full(1, conf["init_mu_bias"]), "log_std": full(1, conf["init_log_std"]),
            "w_v": w_v.view(H, 1) * math.sqrt(2.0 / H), "b_v": full(1, 0.0)}


def names_of(B: int) -> list:
    base = ref_tables.patient_names()
    return [base[i % len(base)] for i in range(B)]


def loss_of(conf: dict, m: dict) -> float:
    return float(m["pg_loss"]) + conf["vf_coef"] * float(m["v_loss"]) - conf["ent_coef"] * float(
        m["entropy"])


def leaf_norms(flat: torch.Tensor, like: dict) -> torch.Tensor:
    parts = torch.split(flat.double(), [like[k].numel() for k in ref_ppo.LEAVES])
    return torch.stack([p.norm() for p in parts])


def worst_leaf_gap(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor) -> float:
    """The largest gap of leaf norms over the kept leaves, each against the
    larger of its own norm and the median leaf's."""
    scale = torch.maximum(want, want.median())
    return float(((got - want).abs() / scale)[keep].max())


def reference_state(state_f: torch.Tensor, state_i: torch.Tensor, dtype) -> dict:
    """The program's simulator state planes (``[64, rows, 128]`` float32,
    ``[7, rows, 128]`` int32; lane ``b`` at ``[:, b // 128, b % 128]``) as
    the reference's rollout state, by the plane map the program documents
    (``ops/rollout.py``: 0-12 the ODE, 13 planned meal, 14 last CHO, 15
    eating, 16 last Qsto, 17 food taken, 18 last CGM, 19 the AR(1) state,
    20-23 the noise lattice, 24-29 meal times, 30-35 meal grams, 36 PID
    integral, 37 PID previous, 38 previous risk, 39 previous CHO, 40 the
    controller's last CGM, 61 last insulin, 62 the CGM before, 63 insulin
    on board; int planes 0 minutes, 1 start minute, 2 day, 4 next lattice
    point, 5 CGM samples)."""
    f = state_f.reshape(state_f.shape[0], -1).to(dtype)
    i = state_i.reshape(state_i.shape[0], -1)
    s = dict(planned=f[13], last_CHO=f[14], eating=f[15] > 0.5, last_Qsto=f[16],
             foodtaken=f[17], last_CGM=f[18], e=f[19], lat=[f[20 + k] for k in range(4)],
             pid_integ=f[36], pid_prev=f[37], prev_risk=f[38], prev_cho=f[39],
             ctrl_prev=f[40], ins_prev=f[61], ctrl_pprev=f[62], iob=f[63], t_min=i[0],
             start_min=i[1], day=i[2], lat_next=i[4], n_samp=i[5])
    return dict(xs=tuple(f[k] for k in range(13)), meal_t=[f[24 + k] for k in range(6)],
                meal_a=[f[30 + k] for k in range(6)], s=s)


def leaf_shapes(H: int) -> dict:
    return {"w1": (7, H), "b1": (H,), "w2": (H, H), "b2": (H,), "w_mu": (H, 1), "b_mu": (1,),
            "log_std": (1,), "w_v": (H, 1), "b_v": (1,)}


def reference_iterations(conf: dict, wl: dict, policy: dict, opt: dict, sim, gen, n: int,
                         dtype, fault: str = None) -> dict:
    """``n`` reference iterations from ``policy`` (leaves in ``dtype``),
    Adam's state ``opt``, the simulator state ``sim`` (None: fresh
    episodes) and the generator ``gen`` that draws each iteration's rollout
    key and block permutations as the program's does: the metrics of each,
    Adam's first moment after the first, the flat params before and
    after, the simulator state left."""
    B, T = wl["batch"], wl["rollout_steps"]
    device = policy["w1"].device
    fields = ref.sensor_pump(ref_tables.by_name("sensor")[conf["sensor"]],
                             ref_tables.by_name("pump")[conf["pump"]])
    rcfg = ref.Config(n_steps=T, controller="nn", action_scale=conf["action_scale"], **fields)
    pt = ref_tables.patients(names_of(B), device, dtype)
    lanes = torch.arange(B, dtype=torch.int64, device=device)
    n_blocks = ref_ppo.blocking(conf, B * T)[1]
    out = {"metrics": [], "flat0": ref_ppo.flatten(policy).float()}
    with torch.no_grad():
        for k in range(n):
            key = tuple(int(x) for x in torch.randint(0, 2 ** 31 - 1, (2,), generator=gen))
            perms = [torch.randperm(n_blocks, generator=gen) for _ in range(conf["epochs"])]
            with torch.enable_grad():
                policy, opt, sim, m = ref_ppo.iteration(conf, rcfg, pt, lanes, policy, opt, sim,
                                                        key, perms, fault=fault)
            out["metrics"].append({k_: float(v) for k_, v in m.items()})
            if k == 0:
                out["moment"] = opt["mu"].float().clone()
    out["flat"] = ref_ppo.flatten(policy).float()
    out["sim"] = sim
    out["like"] = policy
    return out


def reference_run(conf: dict, wl: dict, seed: int, device, dtype=torch.float32,
                  fault: str = None) -> dict:
    """The reference's first ``check_steps`` iterations from the seed's
    policy, Adam's zero state and the seed's generator."""
    policy = {k: v.to(dtype) for k, v in initial_policy(conf, seed, device).items()}
    flat0 = ref_ppo.flatten(policy)
    opt = {"count": 0, "mu": torch.zeros_like(flat0), "nu": torch.zeros_like(flat0)}
    gen = torch.Generator().manual_seed(draws.seed64(seed, "trainer"))
    return reference_iterations(conf, wl, policy, opt, None, gen, wl["check_steps"], dtype,
                                fault)


def reference_from(conf: dict, wl: dict, start: dict, device, dtype=torch.float32,
                   fault: str = None) -> dict:
    """The reference's ``iters_per_call`` iterations of one window call,
    from the state the program's call started from (``start``: the flat
    params, Adam's count and moments, the simulator's planes, the
    generator's state)."""
    shapes = leaf_shapes(conf["hidden"])
    flat = start["flat"].to(device, dtype)
    parts = torch.split(flat, [math.prod(shapes[k]) for k in ref_ppo.LEAVES])
    policy = {k: p.view(shapes[k]) for k, p in zip(ref_ppo.LEAVES, parts)}
    opt = {"count": start["count"], "mu": start["mu"].to(device, dtype),
           "nu": start["nu"].to(device, dtype)}
    sim = None if start["init"] else reference_state(start["state_f"].to(device),
                                                     start["state_i"].to(device), dtype)
    gen = torch.Generator()
    gen.set_state(start["generator"])
    return reference_iterations(conf, wl, policy, opt, sim, gen, wl["iters_per_call"], dtype,
                                fault)


def compare(conf: dict, got: dict, want: dict) -> dict:
    """The numbers compared: the worst relative gap of an iteration's loss;
    the worst leaf's gap of Adam's first moment after the first iteration;
    the worst leaf's gap of the params' change after the last.  Leaves
    whose first moment in the reference is under a thousandth of the median
    leaf's are left out of both."""
    lp = [loss_of(conf, m) for m in got["metrics"]]
    lr = [loss_of(conf, m) for m in want["metrics"]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    like = want["like"]
    m_ref = leaf_norms(want["moment"], like)
    keep = m_ref >= 1e-3 * m_ref.median()
    return {
        "loss_gap": loss_gap,
        "moment_gap": worst_leaf_gap(leaf_norms(got["moment"], like), m_ref, keep),
        "update_gap": worst_leaf_gap(leaf_norms(got["flat"] - got["flat0"], like),
                                     leaf_norms(want["flat"] - want["flat0"], like), keep),
    }


def control(conf: dict, wl: dict, seed: int, device="cuda") -> dict:
    """The reference in bfloat16 put in the program's place."""
    want = reference_run(conf, wl, seed, device)
    return compare(conf, reference_run(conf, wl, seed, device, dtype=torch.bfloat16), want)


def fault(conf: dict, wl: dict, seed: int, device="cuda", kind: str = "half_batch") -> dict:
    """A fault planted in the reference put in the program's place."""
    want = reference_run(conf, wl, seed, device)
    return compare(conf, reference_run(conf, wl, seed, device, fault=kind), want)


def on(device, d: dict) -> dict:
    return {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in d.items()}


class Training(Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        from simglucose_tpu_torch import params as tables
        from simglucose_tpu_torch.models.uva_padova import basal_rate
        from simglucose_tpu_torch.ops.rollout import pack_params
        from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_loop
        from simglucose_tpu_torch.rl.policy import PolicyParams
        from simglucose_tpu_torch.rl.ppo import PPOConfig, flatten_params, make_optimizer

        wl, conf = ctx.workload, ctx.config
        if wl["iters_per_call"] != 1:
            raise ValueError("the window's checks follow calls of one iteration")
        B, T = wl["batch"], wl["rollout_steps"]
        self.work_per_call = B * T * wl["iters_per_call"]
        cfg = PPOConfig(rollout_steps=T, epochs=conf["epochs"], minibatches=conf["minibatches"],
                        gamma=conf["gamma"], lam=conf["lam"], clip_eps=conf["clip_eps"],
                        vf_coef=conf["vf_coef"], ent_coef=conf["ent_coef"], lr=conf["lr"],
                        max_grad_norm=conf["max_grad_norm"], shuffle_block=conf["shuffle_block"],
                        action_scale=conf["action_scale"], init_log_std=conf["init_log_std"],
                        pallas_learner=True)
        patient = tables.load_patient_params(names_of(B), device=self.device)
        self.packed = pack_params(patient, basal_rate(patient))
        params = PolicyParams(**initial_policy(conf, ctx.seed, self.device), act=conf["act"],
                              action_scale=conf["action_scale"], decoder="sigmoid")
        gen = torch.Generator().manual_seed(draws.seed64(ctx.seed, "trainer"))
        self.ts = init_fused_state(params, make_optimizer(cfg).init(params), B, gen)
        self.loop = make_fused_train_loop(cfg, B, wl["iters_per_call"], hidden=conf["hidden"],
                                          sensor=conf["sensor"], kernel_prep=True)
        self._flat = flatten_params
        self.sample = draws.Reservoir(ctx.seed, wl["window_checks"])
        self.kept, self.i = {}, 0
        # the first steps, through the window's own call
        self.got = {"flat0": flatten_params(params).clone(), "metrics": []}
        for k in range(wl["check_steps"]):
            self.ts, m = self.loop(self.packed, self.ts)
            self.got["metrics"].append({n: float(m[n][-1]) for n in METRICS})
            if k == 0:
                self.got["moment"] = self.ts.opt_state.mu.clone()
        self.got["flat"] = flatten_params(self.ts.params).clone()

    def _start(self) -> dict:
        """What the next call starts from, copied."""
        ts = self.ts
        return {"flat": self._flat(ts.params).clone(), "count": int(ts.opt_state.count),
                "mu": ts.opt_state.mu.clone(), "nu": ts.opt_state.nu.clone(),
                "state_f": ts.state_f.clone(), "state_i": ts.state_i.clone(),
                "init": int(ts.init), "generator": ts.generator.get_state()}

    def call(self):
        kept = self.sample.offer(self.i)
        if kept:
            self.kept.pop(self.sample.evicted, None)
            start = self._start()
        self.ts, m = self.loop(self.packed, self.ts)
        host = torch.stack([m[n] for n in METRICS]).cpu()
        if not torch.isfinite(host).all():
            self.failed += 1
        if kept:
            self.kept[self.i] = {"start": start, "got": {
                "flat0": start["flat"], "flat": self._flat(self.ts.params).clone(),
                "moment": self.ts.opt_state.mu.clone(),
                "state_f": self.ts.state_f.clone(), "state_i": self.ts.state_i.clone(),
                "metrics": [dict(zip(METRICS, col.tolist())) for col in host.T]}}
        self.i += 1

    def check(self, rec):
        self.ts = self.packed = self.loop = None
        free_cuda()
        conf, wl = self.ctx.config, self.ctx.workload
        want = reference_run(conf, wl, self.ctx.seed, self.device)
        numbers = compare(conf, on(want["flat"].device, self.got), want)
        self.window_want = {i: reference_from(conf, wl, k["start"], self.device)
                            for i, k in sorted(self.kept.items())}
        numbers.update(self.window_numbers({i: k["got"] for i, k in self.kept.items()}))
        return self.numbers(numbers)

    def window_numbers(self, got: dict) -> dict:
        """The worst of the window calls' numbers, ``got`` by call, each
        against the reference's from the call's start."""
        out = {}
        for i, want in self.window_want.items():
            for k, v in compare(self.ctx.config, on(want["flat"].device, got[i]), want).items():
                out["window_" + k] = max(out.get("window_" + k, 0.0), v)
        return out

    def window_look(self) -> list:
        """Calibration only, after ``check``: for each kept call its
        numbers beside the lanes whose simulator state the program and the
        reference left apart: an episode counter differing (one side
        reset) or the last CGM off by more than 1e-3 relative."""
        out = []
        for i, want in sorted(self.window_want.items()):
            got = self.kept[i]["got"]
            mine = reference_state(got["state_f"], got["state_i"], torch.float32)["s"]
            ref_s = want["sim"]["s"]
            reset = mine["t_min"].to(ref_s["t_min"].device) != ref_s["t_min"]
            cgm = ((mine["last_CGM"].to(ref_s["last_CGM"].device) - ref_s["last_CGM"]).abs()
                   > 1e-3 * ref_s["last_CGM"].abs())
            nums = compare(self.ctx.config, on(want["flat"].device, got), want)
            out.append(dict(call=i, **nums, lanes_reset_apart=int(reset.sum()),
                            lanes_cgm_apart=int((cgm & ~reset).sum())))
        return out

    def window_readings(self, kind: str) -> dict:
        """Calibration only, after ``check``: the window numbers of the
        reference in bfloat16 (``kind='control'``) or with a fault planted
        (``'half_batch'``) put in the program's place at each kept call."""
        conf, wl = self.ctx.config, self.ctx.workload
        opts = {"dtype": torch.bfloat16} if kind == "control" else {"fault": kind}
        return self.window_numbers({i: reference_from(conf, wl, k["start"], self.device, **opts)
                                    for i, k in self.kept.items()})


def setup(ctx):
    return Training(ctx)
