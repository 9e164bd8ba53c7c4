"""K1a, the closed-loop rollout with a PID, basal-bolus or constant
controller: operations per env step by op class, counted from the kernel
body of ``csrc/rollout_math.cuh`` when this benchmark was written (1561
FLOP and 27.6 transcendentals per step at Dexcom's 3-minute samples with
PID).  fma counts 2 FLOP; mul, div and select 1; tanh, exp and log are
transcendentals; powf counts one log and one exp.  Not counted: auto-resets
and midnight meal-plan draws (under 2% of lane-steps).

One simulated minute (run ``sample_time`` times a step): four ODE
right-hand sides, the minute's gastric constants, the RK4 stages, the
meal lookup and eating machine, the BG and the step means.  Once a step:
the insulin rate, the CGM sample and its Catmull-Rom, risk, reward and
done.  Once a lattice point (every 15 / sample_time steps): Box-Muller,
the AR(1) step, Johnson-SU.  The PID controller and the pump once a step.

Bytes: the 50 packed parameter planes read, the six [T, B] trajectory
planes, the two-row reset and the 64 + 7 state planes written, 4 bytes
each."""
from __future__ import annotations

MIX_PER_MINUTE = dict(fma=145, mul=141, div=15, select=55, tanh=8)
MIX_PER_STEP = dict(fma=6, mul=18, div=2, select=6, exp=1, log=2)
MIX_PER_LATTICE_POINT = dict(fma=1, mul=9, div=3, select=2, exp=2, log=1)
MIX_PID = dict(fma=3, mul=6, div=3, select=2)
LATTICE_MIN = 15
FLOP_PER_OP = dict(fma=2, mul=1, div=1, select=1)
SFU_OPS = ("tanh", "exp", "log")


def mix(sample_time: int = 3, controller: str = "pid") -> dict:
    """Operations per env step by op class."""
    out = {}
    for part, n in ((MIX_PER_MINUTE, sample_time), (MIX_PER_STEP, 1),
                    (MIX_PER_LATTICE_POINT, sample_time / LATTICE_MIN),
                    (MIX_PID, 1 if controller == "pid" else 0)):
        for c, v in part.items():
            out[c] = out.get(c, 0) + n * v
    return out


def per_step(sample_time: int = 3, controller: str = "pid") -> tuple:
    """(FLOP, transcendentals) per env step."""
    m = mix(sample_time, controller)
    return (sum(FLOP_PER_OP[c] * v for c, v in m.items() if c in FLOP_PER_OP),
            sum(v for c, v in m.items() if c in SFU_OPS))


def count(B: int, T: int, sample_time: int = 3, controller: str = "pid") -> dict:
    flop, sfu = per_step(sample_time, controller)
    floats = 50 * B + 6 * B * T + 2 * B + (64 + 7) * B
    return {"flop": B * T * flop, "sfu": B * T * sfu, "bytes": 4 * floats}
