"""gym 0.9.4-compatible seeding, re-implemented from its documented behavior.

The port's copy of ``simglucose_tpu/compat/seeding.py`` (host code, numpy
and the standard library only).

The reference's gym adapter derives its episode randomness through gym
0.9.4's ``gym.utils.seeding`` (reference: envs/simglucose_gym_env.py:58-73):

    seed2 = hash_seed(np_random.randint(0, 1000)) % 2**31   # sensor seed
    seed3 = hash_seed(seed2 + 1) % 2**31                    # scenario seed
    seed4 = hash_seed(seed3 + 1) % 2**31                    # patient seed
    hour  = np_random.randint(0, 24)                        # start hour

where ``hash_seed`` is the first 8 bytes of sha512(str(seed)) read as a
little-endian bigint, and ``np_random(seed)`` seeds a numpy RandomState with
that bigint split into uint32 limbs.  Reproducing this chain bit-for-bit is
what makes ``env.seed(0)`` land on the reference's exact start time
(reference tests/test_seed.py:14-21: seed 0 -> 2018-01-01 23:00:00).
"""
from __future__ import annotations

import hashlib
import os
import struct

import numpy as np


def _bigint_from_bytes(bt: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(bt) % sizeof_int
    bt += b"\0" * padding
    int_count = len(bt) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bt)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int):
    if bigint < 0:
        raise ValueError(f"seed must be non-negative, not {bigint}")
    if bigint == 0:
        return [0]
    ints = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2**32)
        ints.append(mod)
    return ints


def create_seed(a=None, max_bytes: int = 8) -> int:
    """Derive a usable int seed from None/int/str."""
    if a is None:
        return _bigint_from_bytes(os.urandom(max_bytes))
    if isinstance(a, int):
        return a % 2 ** (8 * max_bytes)
    if isinstance(a, str):
        a = a.encode("utf8")
        return _bigint_from_bytes(a[-max_bytes:])
    raise ValueError(f"invalid seed type: {type(a)}")


def hash_seed(seed=None, max_bytes: int = 8) -> int:
    """sha512-based seed whitening (gym 0.9.4 semantics)."""
    if seed is None:
        seed = create_seed(max_bytes=max_bytes)
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def np_random(seed=None):
    """Seeded RandomState + the seed used (gym 0.9.4 semantics)."""
    seed = create_seed(seed)
    rng = np.random.RandomState()
    rng.seed(_int_list_from_bigint(hash_seed(seed)))
    return rng, seed


def gym_seed_chain(np_random_obj: np.random.RandomState):
    """The reference gym env's per-episode seed derivation
    (simglucose_gym_env.py:62-67).  Returns (seed2, seed3, seed4, hour)."""
    seed2 = hash_seed(int(np_random_obj.randint(0, 1000))) % 2**31
    seed3 = hash_seed(seed2 + 1) % 2**31
    seed4 = hash_seed(seed3 + 1) % 2**31
    hour = int(np_random_obj.randint(low=0, high=24))
    return seed2, seed3, seed4, hour
