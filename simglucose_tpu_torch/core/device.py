"""The device an entry point of the port runs on.

Every public function of the port that takes ``device`` defaults to
``"cuda"`` and resolves it here: on a machine without CUDA that raises
rather than running on the CPU unannounced.  The CPU, where each kernel's
plain PyTorch version runs, is asked for explicitly (``device="cpu"``).

A card is named by ``nvidia-smi`` through its UUID (:func:`smi_query`):
torch's device index need not be ``nvidia-smi``'s, under
``CUDA_VISIBLE_DEVICES`` or with CUDA's enumeration order.
"""
from __future__ import annotations

import subprocess

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


def card_uuid(index=None) -> str:
    """``GPU-<uuid>`` of the card torch calls ``index`` (the current card
    by default), as ``nvidia-smi -i`` takes it."""
    if index is None:
        index = torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def smi_query(fields: str, index=None, units: bool = True) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` (with
    ``nounits`` where ``units`` is False) of the card torch calls
    ``index`` (the current card by default), asked by its UUID."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", "-i", card_uuid(index), f"--query-gpu={fields}", f"--format={fmt}"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def card_label(index=None) -> str:
    """``name, power.limit`` of the card torch calls ``index`` (the current
    card by default), as ``nvidia-smi`` gives them."""
    return smi_query("name,power.limit", index)
