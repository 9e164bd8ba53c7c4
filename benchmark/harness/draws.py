"""Everything a run draws from ``--seed``: the same seed gives the same
keys, samples and weights.  A seed may be any whole number; it is folded
to 64 bits through numpy's SeedSequence."""
from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one named use of the seed."""
    tag = [ord(ch) for ch in stream]
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([abs(int(seed)), *tag])))


def seed64(seed: int, stream: str) -> int:
    """A 63-bit integer seed for one named use (torch generators)."""
    return int(rng(seed, stream).integers(0, 2 ** 63 - 1))


class CallKeys:
    """The per-call Philox keys of a run: call ``i`` gets the ``i``-th pair
    of 32-bit words of the seed's ``keys`` stream, whatever the number of
    calls the window completes."""

    def __init__(self, seed: int, block: int = 4096):
        self._rng, self._block, self._keys = rng(seed, "keys"), block, np.zeros((0, 2), np.int64)

    def __getitem__(self, i: int) -> tuple:
        while i >= len(self._keys):
            more = self._rng.integers(0, 2 ** 32, size=(self._block, 2), dtype=np.int64)
            self._keys = np.concatenate([self._keys, more])
        return int(self._keys[i, 0]), int(self._keys[i, 1])


class Reservoir:
    """A uniform sample of ``k`` of the calls of a window, drawn from the
    seed as the calls complete (reservoir sampling): ``offer(i)`` says
    whether call ``i`` enters the sample, ``evicted`` which call it
    replaced (or None)."""

    def __init__(self, seed: int, k: int):
        self.k, self._rng, self.chosen = k, rng(seed, "sample"), []
        self.evicted = None

    def offer(self, i: int) -> bool:
        self.evicted = None
        if len(self.chosen) < self.k:
            self.chosen.append(i)
            return True
        j = int(self._rng.integers(0, i + 1))
        if j < self.k:
            self.evicted, self.chosen[j] = self.chosen[j], i
            return True
        return False
