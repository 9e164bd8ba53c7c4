"""Philox-4x32-10 (Salmon et al., SC'11), counter-based: the same function
of (counter, key) wherever it is computed, so the reference draws what
the program draws from the same keys and counters.

Words are held in int64 tensors in [0, 2**32); every product and sum is
masked back to 32 bits.  Key words may be ints or per-lane tensors.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor):
    x_lo, x_hi = x & 0xFFFF, x >> 16
    a, b = m * x_lo, m * x_hi
    mid = ((b & 0xFFFF) << 16) + a
    return ((b >> 16) + (mid >> 32)) & MASK32, mid & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Four int64 tensors of 32-bit words: Philox-4x32-10 of the counter
    (c0, c1, c2, c3) under the key (k0, k1), broadcast together."""
    ref = next(c for c in (c0, c1, c2, c3, k0, k1) if isinstance(c, torch.Tensor))

    def word(c):
        if isinstance(c, torch.Tensor):
            return c.to(torch.int64) & MASK32
        return torch.full((), int(c) & MASK32, dtype=torch.int64, device=ref.device)

    c0, c1, c2, c3 = torch.broadcast_tensors(*(word(c) for c in (c0, c1, c2, c3)))
    k0, k1 = word(k0), word(k1)
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The top 24 bits of a word as U(0, 1) in [1e-7, 1), in ``dtype``."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.clamp(u, min=1e-7).to(dtype)
