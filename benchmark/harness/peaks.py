"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates): 67 TFLOP/s of float32 outside the tensor cores
(132 SMs x 128 lanes x 2 FLOP at 1.98 GHz), 3.35 TB/s of HBM, and the
special-function units' 16 transcendentals per SM per clock (the CUDA
programming guide's throughput table for compute capability 9.0) at that
clock.  A card set below 700 W runs slower under load: the run prints its
power limit beside every share of these peaks."""
from __future__ import annotations

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def bound_s(flop: float, bytes: float, sfu: float = 0.0) -> float:
    """The least time for ``flop`` float32 operations, ``sfu``
    transcendentals and ``bytes`` of device memory traffic, the pipes
    running side by side (a count of :mod:`benchmark.counts` as keywords)."""
    return max(flop / F32_FLOP_PER_S, sfu / SFU_OPS_PER_S, bytes / HBM_BYTES_PER_S)
