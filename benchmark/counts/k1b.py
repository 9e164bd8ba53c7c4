"""K1b, the rollout with the relu 7-H-H Gaussian policy inside: K1a's
count without the PID, plus per env step the MLP (2 (9H + H^2) FLOP:
two layers and the two heads), ~25 FLOP of features, decoder and
log-prob, and 9 transcendentals (5 tanh features, the sigmoid's exp, the
action noise's log, sqrt and cos).  Bytes: K1a's, plus the H x (H + 16)
weight buffer read, the 10 learner rows (or 6 observation planes) a
step and 5 tail rows written."""
from __future__ import annotations

from benchmark.counts import k1a

NN_FLOP_PER_STEP, NN_SFU_PER_STEP = 25, 9


def count(B: int, T: int, H: int, sample_time: int = 3, emit_learner_rows: bool = True) -> dict:
    out = k1a.count(B, T, sample_time, controller="nn")
    steps = B * T
    out["flop"] += steps * (2 * (9 * H + H * H) + NN_FLOP_PER_STEP)
    out["sfu"] += steps * NN_SFU_PER_STEP
    out["bytes"] += 4 * (H * (H + 16) + (10 if emit_learner_rows else 6) * steps + 5 * B)
    return out
