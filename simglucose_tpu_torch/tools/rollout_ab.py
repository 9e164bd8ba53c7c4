"""The rollout kernels K1a and K1b and the learner kernels K2-K5 of one
checkout, timed on the card, and the SASS of its rollout and learner
kernels.

Run by path on a machine with an NVIDIA GPU.  To compare two commits on one
card, unpack the other (``git archive``) under ``scratch/`` and run both in
one session in turns (parent, change, change, parent)::

    python3 simglucose_tpu_torch/tools/rollout_ab.py --label change --e2e
    python3 simglucose_tpu_torch/tools/rollout_ab.py --root scratch/parent --label parent --e2e

``--parts learner`` times the learner kernels alone (``--parts
rollout,learner`` both).

It imports the package of ``--root`` (default: the checkout holding this
file) and calls only its public entry points, so an older commit runs under
the same measurement: ``chip_smoke.py`` of this checkout, loaded by path,
gives the shapes and the timers.  Holding the kernels against their plain
versions is ``chip_smoke.py``'s work; here every timed shape runs twice and
the two results must hold the same bits, and a digest of every output of
the K1a and K1b runs is printed (``outputs_sha``), so that two checkouts
can be told to compute the same bits or not.  It prints JSON lines, each
with the card's name and power limit:

* K1b at bench.py's fused config (B=8192, T=64) with fresh relu policies of
  H=64 and H=128: ms per call by CUDA events around each call, and back to
  back;
* K1a at B=4096, PID, auto-reset: T=64 back to back, T=4096 per call;
* ptxas' register and spill lines of the rollout and learner kernels, and
  each rollout and learner kernel's instruction count, ``MUFU.RCP``, call,
  shuffle and tensor-core (``HMMA``) sites and a hash of its opcode
  sequence in its SASS (cuobjdump), under its mangled name without the
  anonymous namespace, so that two checkouts' kernels can be told to
  compile to the same code or not;
* with ``learner`` in ``--parts``: K2 (``gae_pack``) at bench.py's fused
  shape (B=8192, T=64) and at ``chip_smoke.K2_LONG_T`` steps: ms alone,
  back to back and by events around each call, and host microseconds a
  call (``gae_times``); K3 (``ppo_grad_step_gather2``), K4
  (``ppo_grad_step_gather``) and K5 (``ppo_epoch_update``) at float32 and
  bfloat16, H=64 and H=128 (relu), at bench.py's fused learner shapes
  (a 524288-column buffer made from a seed, 2048-row shuffle blocks, 64 a
  minibatch, 2 epochs x 4 minibatches): K3/K4 ms queued behind a sleep of
  the card (``chip_smoke.device_ms``: the kernels alone), back to back and
  by events around each call, K5 ms behind a sleep and by events around
  each call;
* with ``--e2e``: ``evaluate_policy_kernel``'s time to results at 4096
  lanes x 24 h (residual-BB checkpoint, seed 5) and fused PPO iterations
  per second on the ``kernel_prep`` path and on the plane path with the
  'epoch' learner, with each one's rollout stage back to back.

Without CUDA the tool fails: a time is only ever the card's.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def kernel_name(mangled: str) -> str:
    """A mangled kernel name without its anonymous namespace, whose id
    changes from build to build."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N__", mangled)
    return "_ZN" + mangled[m.end(1) + int(m.group(1)):] if m else mangled


def sass_sites(sass: str) -> dict:
    """{kernel: {total, rcp, call, shfl, hmma, opcode_sha}} of the rollout
    and learner kernels in a SASS listing: all instructions, ``MUFU.RCP``,
    ``CALL*``, ``SHFL*`` and ``HMMA*`` sites, and the first 16 hex digits of
    the SHA-256 of the opcode sequence."""
    fn, ops = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            fn = fn if re.search(r"rollout|ppo_(grad|epoch)_kernel", fn) else None
            if fn:
                ops[fn] = []
            continue
        m = _SASS_OP.search(line)
        if fn and m:
            ops[fn].append(m.group(1))
    out = {}
    for k, seq in ops.items():
        c = collections.Counter(seq)
        pick = lambda pre: sum(v for op, v in c.items() if op.startswith(pre))  # noqa: E731
        out[k] = dict(total=len(seq), rcp=c["MUFU.RCP"], call=pick("CALL"), shfl=pick("SHFL"),
                      hmma=pick("HMMA"), opcode_sha=hashlib.sha256(" ".join(seq).encode()).hexdigest()[:16])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_CHECKOUT, help="the checkout whose package is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--parts", default="rollout", help="comma-separated: rollout, learner")
    ap.add_argument("--e2e", action="store_true", help="also evaluation and fused PPO")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("rollout_ab measures the card: CUDA is not available")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_CHECKOUT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo
    from simglucose_tpu_torch.rl.fused import fused_rollout_config

    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(tr.__file__))))
    if pkg != root:
        sys.exit(f"the package came from {pkg}, not {root}: run this file by path")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()

    def emit(what, data):
        print(json.dumps({"label": args.label, "device": smi, what: data}), flush=True)

    build.load_library()
    ptxas = build.BUILD_INFO["ptxas"].splitlines()
    mine = re.compile(r"rollout|ppo_(grad|epoch)_kernel")
    emit("ptxas", [ln.strip() for i, ln in enumerate(ptxas)
                   if mine.search(ln) or ("Used" in ln or "spill" in ln)
                   and any(mine.search(p) for p in ptxas[max(0, i - 3):i])])
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        emit("sass", sass_sites(subprocess.run([cuobjdump, "-sass", build.BUILD_INFO["path"]], check=True,
                                               capture_output=True, text=True, timeout=300).stdout))

    def twice_same(fn, what):
        """Two runs of ``fn`` hold the same bits; returns a digest of them."""
        out = fn()
        if not cs.bit_identical(out, fn()):
            sys.exit(f"{args.label}: two runs of {what} differ")
        h = hashlib.sha256()
        for k in sorted(out):
            h.update(out[k].contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def packed_for(n, quest=True):
        names = tables.cohort_names(n)
        p = tables.load_patient_params(names, device=dev)
        q = tables.load_quest_params(names, device=dev) if quest else None
        return tr.pack_params(p, basal_rate(p), quest=q)

    parts = set(args.parts.split(","))
    pcfg = ppo.PPOConfig(rollout_steps=cs.FUSED_T, epochs=2, minibatches=4, pallas_learner=True,
                         shuffle_block=2048)
    if "learner" in parts:
        differ = lambda what: sys.exit(f"{args.label}: two runs of {what} differ")  # noqa: E731
        gae_times(dev, pcfg, cs, emit, differ)
        learner_times(dev, pcfg, cs, emit, differ)
    if "rollout" not in parts:
        return

    # ---- K1b ----
    packed_f = packed_for(cs.FUSED_B, quest=False)
    for H, seed in ((cs.FUSED_H, 1), (cs.WIDE_H, 2)):
        policy = pol.init_policy(torch.Generator().manual_seed(seed), hidden=H, act="relu",
                                 init_mu_bias=-2.2, device=dev)
        w = tr.pack_policy_weights(policy)
        bench = fused_rollout_config(pcfg, hidden=H)
        sha = twice_same(lambda: tr.rollout(bench, packed_f, (0, 1), weights=w), f"K1b at H={H}")
        emit(f"k1b_H{H}", dict(
            outputs_sha=sha,
            ms_per_call=cs.cuda_ms(lambda i: tr.rollout(bench, packed_f, (i, 1), weights=w), 5),
            ms_back_to_back=cs.queued_ms(lambda: tr.rollout(bench, packed_f, (3, 1), weights=w), 10)))

    # ---- K1a ----
    pk = packed_for(4096, quest=False)
    short = tr.RolloutConfig(n_steps=64, controller="pid")
    head = tr.RolloutConfig(n_steps=4096, controller="pid")
    sha = twice_same(lambda: tr.rollout(head, pk, (1, 0)), "K1a at the headline")
    emit("k1a_B4096", dict(outputs_sha=sha, T64_ms_back_to_back=cs.queued_ms(lambda: tr.rollout(short, pk, (3, 0)), 20),
                           T4096_ms_per_call=cs.cuda_ms(lambda i: tr.rollout(head, pk, (i + 1, 0)), 3)))
    if not args.e2e:
        return

    # ---- end to end ----
    from simglucose_tpu_torch.rl import evaluate as ev
    from simglucose_tpu_torch.rl import fused

    resid = pol.load_policy_npz(os.path.join(root, "examples", "checkpoints", "ppo_cohort_residual_bb.npz"),
                                device=dev, act="relu", action_scale=1.1, decoder="residual_bb")
    names = tables.cohort_names(4096)
    ev.evaluate_policy_kernel(resid, names, hours=24.0, seed=5)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        r = ev.evaluate_policy_kernel(resid, names, hours=24.0, seed=5)
        walls.append(time.perf_counter() - tic)
    out = dict(eval4096_s=walls, eval4096_RI=float(r["risk_index"].mean()))
    fresh = pol.init_policy(torch.Generator().manual_seed(1), hidden=cs.FUSED_H, act="relu",
                            init_mu_bias=-2.2, device=dev)
    for name, learner, prep in (("kernel_prep", True, True), ("plane_epoch", "epoch", False)):
        cfg = dataclasses.replace(pcfg, pallas_learner=learner)
        opt = ppo.make_optimizer(cfg)
        ts = fused.init_fused_state(fresh, opt.init(fresh), cs.FUSED_B, torch.Generator().manual_seed(0))
        kw = dict(hidden=cs.FUSED_H, kernel_prep=prep)
        ts, _ = fused.make_fused_train_step(cfg, cs.FUSED_B, **kw)(packed_f, ts)
        loop = fused.make_fused_train_loop(cfg, cs.FUSED_B, cs.FUSED_ITERS, **kw)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        ts, _ = loop(packed_f, ts)
        b.record()
        torch.cuda.synchronize()
        out[f"{name}_it_s"] = cs.FUSED_ITERS / (a.elapsed_time(b) / 1e3)
        stage = fused.make_fused_train_step(cfg, cs.FUSED_B, stages="rollout", **kw)
        out[f"{name}_rollout_stage_ms"] = cs.queued_ms(lambda: stage(packed_f, ts), 5)
    emit("e2e", out)


def _tensors(x) -> list:
    """Every tensor of a grad step's or K5's result."""
    import torch

    if torch.is_tensor(x):
        return [x]
    if hasattr(x, "leaves"):
        return x.leaves()
    return [t for v in x if not isinstance(v, int) for t in _tensors(v)]


def gae_times(dev, pcfg, cs, emit, differ) -> None:
    """K2 (``gae_pack``) at bench.py's fused shape (B=8192, T=64; value a
    view of row 7 of a learner buffer, as the fused path passes it) and at
    ``chip_smoke.K2_LONG_T`` steps, on inputs made from seed 1: ms alone
    (queued behind a sleep of the card), back to back and by events around
    each call, the host's microseconds a call, and a digest of the output;
    its two runs must hold the same bits (else ``differ(what)``)."""
    import numpy as np
    import torch

    from simglucose_tpu_torch.ops import ppo_learner as lrn

    rng = np.random.default_rng(1)
    B, out = cs.FUSED_B, {}
    tail = torch.from_numpy(rng.normal(0, 2, B).astype(np.float32)).to(dev)
    for T in (cs.FUSED_T, cs.K2_LONG_T):
        reward = torch.from_numpy(rng.normal(0, 1, (T, B)).astype(np.float32)).to(dev)
        done = torch.from_numpy((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)).to(dev)
        rows = torch.from_numpy(rng.normal(0, 2, (10, T * B)).astype(np.float32)).to(dev)
        value = rows[7].view(T, B)
        k2 = lambda: lrn.gae_pack(reward, done, value, tail, gamma=pcfg.gamma, lam=pcfg.lam)  # noqa: E731
        a, b = k2(), k2()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            differ(f"k2 at T={T}")
        out[f"T{T}"] = dict(outputs_sha=hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16],
                            ms_device=cs.device_ms(k2, 50), ms_back_to_back=cs.queued_ms(k2, 50),
                            ms_per_call=cs.cuda_ms(lambda i: k2(), 20)[10], host_us=cs.host_us(k2, 200))
    emit("k2", dict(B=B, **out))


def learner_times(dev, pcfg, cs, emit, differ) -> None:
    """K3, K4 and K5 at float32 and bfloat16, H=64 and 128, on a 12-row
    buffer of bench.py's fused size made from seed 0 (K3 reads its first 10
    rows and the adv/ret rows as its two buffers), through the package's
    public wrappers; each kernel's two runs must hold the same bits (else
    ``differ(what)``)."""
    import numpy as np
    import torch

    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo

    rng = np.random.default_rng(0)
    N, bs, n_mb = cs.FUSED_B * cs.FUSED_T, pcfg.shuffle_block, pcfg.epochs * pcfg.minibatches
    bpm = N // bs // pcfg.minibatches
    rows = np.zeros((12, N), np.float32)
    rows[0:7] = rng.normal(0, 1, (7, N))
    rows[8] = rng.normal(-1, 1, N)
    rows[9] = rng.normal(-1.2, 0.3, N)
    rows[10:12] = rng.normal(0, 1, (2, N))
    packed = torch.from_numpy(rows).to(dev)
    main, advret = packed[:10].contiguous(), packed[10:].contiguous()
    perm_all = torch.cat([torch.from_numpy(rng.permutation(N // bs)) for _ in range(pcfg.epochs)]).to(dev)
    adv_b = packed[10].view(N // bs, bs)
    mean, std = ppo.minibatch_adv_stats(adv_b.sum(1), (adv_b * adv_b).sum(1), perm_all.view(-1, bpm),
                                        bpm * bs)
    opt = ppo.make_optimizer(pcfg)
    for H in (cs.FUSED_H, cs.WIDE_H):
        p = pol.init_policy(torch.Generator().manual_seed(H), hidden=H, act="relu", init_mu_bias=-2.2,
                            device=dev)
        w = (p.w1, p.b1, p.w2, p.b2, torch.cat([p.w_mu, p.w_v], 1), torch.cat([p.b_mu, p.b_v]),
             p.log_std[0])
        stats = (mean[0], std[0])
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            tag, kw = ("bf16" if dt == torch.bfloat16 else "f32"), dict(act="relu", compute_dtype=dt)
            k3 = lambda: lrn.ppo_grad_step_gather2(main, advret, perm_all[:bpm], bs, *w, *stats, **kw)  # noqa: E731
            k4 = lambda: lrn.ppo_grad_step_gather(packed, perm_all[:bpm], bs, *w, *stats, **kw)  # noqa: E731
            k5 = lambda: lrn.ppo_epoch_update(pcfg, opt, p, opt.init(p), packed, perm_all, bs, mean, std,  # noqa: E731
                                              compute_dtype=dt)
            for name, fn in (("k3", k3), ("k4", k4), ("k5", k5)):
                a, b = _tensors(fn()), _tensors(fn())
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    differ(f"{name} {tag} at H={H}")
            for name, fn in (("k3", k3), ("k4", k4)):
                out[f"{name}_{tag}_ms_device"] = cs.device_ms(fn, 20)
                out[f"{name}_{tag}_ms_back_to_back"] = cs.queued_ms(fn, 20)
                out[f"{name}_{tag}_ms_per_call"] = cs.cuda_ms(lambda i: fn(), 10)[5]
            out[f"k5_{tag}_ms_device"] = cs.device_ms(k5, 5)
            out[f"k5_{tag}_ms_per_call"] = cs.cuda_ms(lambda i: k5(), 5)[2]
        emit(f"learner_H{H}", dict(rows_per_minibatch=bpm * bs, minibatches=n_mb, **out))


if __name__ == "__main__":
    main()
