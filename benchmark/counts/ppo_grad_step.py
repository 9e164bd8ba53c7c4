"""One PPO grad step (K3 on the fused path, K4 on the 12-row buffer) over
``rows`` rows of a relu 7-H-H-2 MLP: forward 9H + H^2 multiply-adds,
backward 11H + 2H^2, and ~8H of biases, activations and their
derivatives per row; every row's 12 floats read once."""
from __future__ import annotations


def flop(rows: int, H: int) -> int:
    return rows * (2 * (20 * H + 3 * H * H) + 8 * H)


def count(rows: int, H: int) -> dict:
    return {"flop": flop(rows, H), "sfu": 0, "bytes": 4 * 12 * rows}
