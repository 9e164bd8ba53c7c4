"""The bytes ``sim/engine.py::_simulate_kernel`` gathers a call over its
ranks (one call of a horizon, no chunking): the BG, CGM, CHO and insulin
planes, ``[4, steps, lanes]``, and the reset row's BG and CGM, ``[2,
lanes]``, float32, over the cohort padded to whole 128-lane rows on every
rank.  At 16384 patients, 480 steps and 4 ranks: 125,960,192 bytes."""
from __future__ import annotations

LANES = 128  # a rank's shard is whole rows of 128 lanes


def count(patients: int, steps: int, ranks: int) -> dict:
    unit = LANES * ranks
    lanes = -(-patients // unit) * unit
    return {"flop": 0.0, "sfu": 0.0, "bytes": 4 * (4 * steps + 2) * lanes}
