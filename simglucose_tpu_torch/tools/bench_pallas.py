"""The rollout kernel K1a alone on the card: env-steps/s at a given shape.

Counterpart of ``tools/bench_pallas.py``.  The PID headline config
(:func:`simglucose_tpu_torch.tools.bench.bench_pallas`'s) at ``B`` patients
and ``T`` steps a call: one warm-up call, then one round of ``N_CALLS``
back-to-back calls timed by the bench's loop (the card synchronized at
both ends, then a host copy of the last reward row).  No law gate, as in
the JAX tool.

Usage: ``N_CALLS=24 python -m simglucose_tpu_torch.tools.bench_pallas [B]
[T]`` (defaults 4096 and 256).  The JAX tool's further arguments
(``block_rows``, ``t_chunk``, ``regen_every``) are the TPU kernel's tiling
and generator cadence, which have no counterpart on the card
(``ops/rollout.py::RolloutConfig``): passing them is a usage error.
Prints one line: ``pallas B=... T=...: ...M env-steps/s``.
"""
from __future__ import annotations

import argparse
import functools
import os

B = 4096
T = 256
N_CALLS = 24


def main(argv=None, device="cuda") -> float:
    """Run the bench, print its line and return env-steps/s."""
    from simglucose_tpu_torch.core.device import check_device
    from simglucose_tpu_torch.ops.rollout import RolloutConfig, rollout
    from simglucose_tpu_torch.tools.bench import _packed, _timed_rounds

    parser = argparse.ArgumentParser(prog="python -m simglucose_tpu_torch.tools.bench_pallas",
                                     description="env-steps/s of the rollout kernel K1a")
    parser.add_argument("sizes", nargs="*", type=int, metavar="B T",
                        help=f"patients and steps a call (default {B} {T})")
    args = parser.parse_args(argv)
    if len(args.sizes) > 2:
        parser.error("block_rows, t_chunk and regen_every are the TPU kernel's tiling and "
                     "generator cadence: they have no counterpart on the card "
                     "(ops/rollout.py RolloutConfig)")
    batch, n_steps = args.sizes + [B, T][len(args.sizes):]
    n_calls = int(os.environ.get("N_CALLS", str(N_CALLS)))
    device = check_device(device)
    cfg = RolloutConfig(n_steps=n_steps, controller="pid")
    run = functools.partial(rollout, cfg, _packed(batch, device))
    sps, _ = _timed_rounds(run, batch, n_steps, n_calls, 1, device)
    print(f"pallas B={batch} T={n_steps}: {sps / 1e6:.2f}M env-steps/s", flush=True)
    return sps


if __name__ == "__main__":
    main()
