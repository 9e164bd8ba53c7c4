"""The device an entry point of the port runs on.

Every public function of the port that takes ``device`` defaults to
``"cuda"`` and resolves it here: on a machine without CUDA that raises
rather than running on the CPU unannounced.  The CPU, where each kernel's
plain PyTorch version runs, is asked for explicitly (``device="cpu"``).
"""
from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """``device`` as a torch.device; 'cuda' raises where CUDA is absent (no
    silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch version of the kernel"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device}")
    return device
