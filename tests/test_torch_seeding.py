"""The port's copies of the gym 0.9.4 seeding chain and of the reference's
random initial state (``simglucose_tpu_torch/compat/seeding.py``,
``compat/patient.py``) against the JAX package's, exactly, and the
reference's start-hour contract (reference tests/test_seed.py:17-23)."""
import numpy as np
import pytest

from simglucose_tpu.compat import patient as jpatient
from simglucose_tpu.compat import seeding as jseeding
from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.compat import patient as tpatient
from simglucose_tpu_torch.compat import seeding as tseeding

SEEDS = list(range(200))


def test_hash_seed_and_create_seed_match_jax():
    for s in SEEDS + [2**40 + 3, "abc", "a longer seed string"]:
        assert tseeding.create_seed(s) == jseeding.create_seed(s)
        assert tseeding.hash_seed(s) == jseeding.hash_seed(s)
    with pytest.raises(ValueError):
        tseeding.create_seed(1.5)


def test_np_random_and_seed_chain_match_jax():
    """200 seeds: the seeded RandomStates draw the same, and three chains
    from each are the same (seed2, seed3, seed4, hour)."""
    for s in SEEDS:
        (t_rng, t_seed), (j_rng, j_seed) = tseeding.np_random(s), jseeding.np_random(s)
        assert t_seed == j_seed == s
        for _ in range(3):
            assert tseeding.gym_seed_chain(t_rng) == jseeding.gym_seed_chain(j_rng)
        assert t_rng.randint(0, 2**31) == j_rng.randint(0, 2**31)


def test_seed_start_hour_contract():
    for seed, expect_hour in [(0, 23), (1000, 14)]:
        rng, _ = tseeding.np_random(seed)
        tseeding.gym_seed_chain(rng)  # consumed by env.seed()
        *seeds, hour = tseeding.gym_seed_chain(rng)  # env.reset()
        assert hour == expect_hour and all(0 <= s < 2**31 for s in seeds)


@pytest.mark.parametrize("name", ["adolescent#001", "adult#004", "child#009"])
def test_reference_init_state_matches_jax(name):
    rec = tables.patient_record(name)
    x0 = np.asarray([rec[f"x0_{i}"] for i in range(1, 14)], np.float64)
    for seed in (0, 7, 2**31 - 1):
        got = tpatient.reference_init_state(x0, seed)
        np.testing.assert_array_equal(got, jpatient.reference_init_state(x0, seed))
        changed = np.flatnonzero(got != x0)
        assert set(changed) <= {3, 4, 12} and len(changed) == 3
