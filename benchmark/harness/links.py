"""The published peak of the links between the cards of one node: NVLink 4
on an H100 SXM, 18 links x 25 GB/s a direction, 450 GB/s a direction a
card (NVIDIA's H100 SXM data sheet: 900 GB/s both ways).  An all-gather's
bus bandwidth (NCCL's definition: (n - 1) / n x the gathered bytes over the
time) is held to it."""
from __future__ import annotations

NVLINK_BYTES_PER_S = 450e9


def busbw_pct(gathered_bytes: float, ranks: int, seconds: float) -> float:
    """100 x an all-gather's bus bandwidth over the link's peak."""
    return 100.0 * (ranks - 1) / ranks * gathered_bytes / seconds / NVLINK_BYTES_PER_S
