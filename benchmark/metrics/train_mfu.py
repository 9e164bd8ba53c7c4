"""The whole iteration's share of the card's float32 peak: the frozen FLOP
of the rollout at the policy's width (:mod:`benchmark.counts.k1b`) and of
epochs x minibatches grad steps (:mod:`benchmark.counts.ppo_grad_step`)
for every iteration of the traced run's untraced window, over that window
by the host's clock at 67 TFLOP/s.  GAE, the clip and Adam are not
counted."""
from benchmark.counts import k1b, ppo_grad_step
from benchmark.harness import layer


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    B, T, H = wl["batch"], wl["rollout_steps"], conf["hidden"]
    n_steps = conf["epochs"] * conf["minibatches"]
    flop = (k1b.count(B, T, H, conf["sample_time"])["flop"]
            + n_steps * ppo_grad_step.flop(B * T // conf["minibatches"], H))
    return layer.mfu_pct(rec, flop * wl["iters_per_call"])
