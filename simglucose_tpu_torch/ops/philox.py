"""Philox-4x32-10 counter-based generator written out in PyTorch.

The plain twin of the generator in ``csrc/rollout_math.cuh``: both compute
the same function of (counter, key), so the CUDA kernel and
:func:`simglucose_tpu_torch.ops.rollout.rollout_reference` draw
bit-identical uniforms.  It replaces the JAX kernel's ``_HwRng``/``_SwRng``
(``simglucose_tpu/ops/pallas_rollout.py:340-379``), whose seed schemes alias
adjacent seeds.

The rollout uses key = (scenario seed, cgm seed) and counter = (global
patient index, global step index, draw-site id, 0), so a stream depends
neither on the launch shape nor on how a horizon is cut into calls.

Torch has no full uint32 arithmetic: words are held in int64 tensors in
[0, 2**32) and every product/sum is masked back to 32 bits; the 64-bit
product of ``mulhilo`` is assembled from two 48-bit partial products.
"""
from __future__ import annotations

import torch

from simglucose_tpu_torch.core.device import check_device

_MASK32 = 0xFFFFFFFF
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m * x, m < 2**32 a
    constant, x an int64 tensor of 32-bit words."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    a = m * x_lo  # < 2**48
    b = m * x_hi  # < 2**48
    mid = ((b & 0xFFFF) << 16) + a  # < 2**49
    lo = mid & _MASK32
    hi = (b >> 16) + (mid >> 32)
    return hi & _MASK32, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 of the counter words under key (k0, k1), each an
    int64 tensor or an int, broadcast together (at least one a tensor).
    Returns four int64 tensors of 32-bit words.  An int word becomes a
    filled tensor on the tensors' device, never a host-to-device copy."""
    ref = next(c for c in (c0, c1, c2, c3, k0, k1) if isinstance(c, torch.Tensor))

    def word(c):
        if isinstance(c, torch.Tensor):
            return c.to(torch.int64) & _MASK32
        return torch.full((), int(c) & _MASK32, dtype=torch.int64, device=ref.device)

    c0, c1, c2, c3 = torch.broadcast_tensors(*(word(c) for c in (c0, c1, c2, c3)))
    k0 = k0 & _MASK32
    k1 = k1 & _MASK32
    for r in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r + 1 < _ROUNDS:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 U(0,1) in [1e-7, 1): the top 24 bits times
    2**-24 (exact in float32), clamped below so ``log(u)`` stays finite."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.clamp(u, min=1e-7)


def philox_words(n: int, key, c1: int, c2: int, device="cuda") -> torch.Tensor:
    """``[n, 4]`` Philox words at counters (i, c1, c2, 0), i < n.

    On a CUDA device the words come from the generator compiled into the
    kernel library (a probe launch), elsewhere from :func:`philox4x32`:
    a check compares the two bit for bit."""
    device = check_device(device)
    k0, k1 = (int(k) & _MASK32 for k in key)
    if device.type == "cuda":
        from simglucose_tpu_torch.ops.build import load_library

        out = torch.empty(n, 4, dtype=torch.int32, device=device)
        err = load_library().sgt_philox_probe(
            out.data_ptr(), n, k0, k1, c1 & _MASK32, c2 & _MASK32,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"philox probe launch failed: CUDA error {err}")
        return out.to(torch.int64) & _MASK32
    i = torch.arange(n, dtype=torch.int64, device=device)
    return torch.stack(philox4x32(i, c1, c2, 0, k0, k1), dim=1)
