"""The grad step's share of its roofline: the least time of one grad step
over a minibatch (:mod:`benchmark.counts.ppo_grad_step`) for every
``ppo_grad_kernel`` launch, over the device time of ``ppo_grad_kernel``
and the ``block_sum_kernel`` that reduces its partial sums."""
from benchmark.counts import ppo_grad_step
from benchmark.harness import layer

PATTERN = r"ppo_grad_kernel|block_sum_kernel"


def read(rec):
    wl, conf = rec["workload"], rec["config"]
    rows = wl["batch"] * wl["rollout_steps"] // conf["minibatches"]
    return layer.roofline_pct(rec, PATTERN, ppo_grad_step.count(rows, conf["hidden"]),
                              per_launch_of=r"ppo_grad_kernel")
