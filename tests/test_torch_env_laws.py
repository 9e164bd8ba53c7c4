"""The laws of the eager env path's native streams.

The port draws from its own Philox streams where the JAX package folds
counters into threefry keys, so the two are held to each other by law:
the CGM noise stream's mean, population std and autocorrelation beside
JAX's on tests/test_noise.py's run (Navigator, 1-min samples, 600 per
sensor) with 512 sensors on each side where that test has 64, so that the
bands can be a few percent; the daily meal plan's
law as tests/test_scenario.py states it, the midnight redraw, and the
closed-loop cohort's BG / residual / CHO-per-day bands.  The same seed pair
gives the same streams; any other pair gives other streams."""
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import torch

from simglucose_tpu.ops.noise import noise_lattice_init, noise_next
from simglucose_tpu.params import load_sensor_params as j_load_sensor
from simglucose_tpu_torch.devices.cgm import sensor_init, sensor_sample
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.params import load_sensor_params
from simglucose_tpu_torch.scenario import meal as tmeal
from simglucose_tpu_torch.sim.engine import simulate_cohort

torch.set_num_threads(1)

N_SENSORS, N_SAMPLES = 512, 600


def _port_noise(seed, n=N_SAMPLES, batch=N_SENSORS, sensor="Navigator"):
    """[batch, n] native noise values (CGM at BG = 0 would clamp: the
    sensor samples BG = 300, and 300 is taken off)."""
    params = load_sensor_params(sensor, dtype=torch.float64, device="cpu")
    state = sensor_init(params, env_keys(seed, batch, device="cpu"), dtype=torch.float64)
    bg = torch.full((batch,), 300.0, dtype=torch.float64)
    out = []
    for _ in range(n):
        state, cgm = sensor_sample(params, 1, state, bg)
        out.append(cgm - 300.0)
    return torch.stack(out, dim=1).numpy()


def _jax_noise(seed, n=N_SAMPLES, batch=N_SENSORS):
    params = j_load_sensor("Navigator", dtype=np.float64)

    @jax.jit
    def run(key):
        def body(carry, i):
            val, carry = noise_next(params, 1, *carry, i, key)
            return carry, val

        _, vals = jax.lax.scan(body, noise_lattice_init(params, key, dtype=jnp.float64), jnp.arange(n))
        return vals

    return np.asarray(jax.vmap(run)(jax.random.split(jax.random.PRNGKey(seed), batch)))


def _acf(x, lag):
    x = x - x.mean()
    return float((x[:, lag:] * x[:, :-lag]).mean() / (x * x).mean())


def test_native_noise_law_matches_jax():
    """Mean, population std (ddof 0, as the JAX bench's law gate) and the
    autocorrelation at 1, 5, 15 and 45 minutes: the port's stream against
    JAX's, both at 512 sensors x 600 samples.  Bands: 5 standard errors of
    the difference of the means (the stream's lattice values are an AR(1)
    of 0.7, so 512 sensors give ~1300 independent values a side), 6% on
    the std, 0.04 on each autocorrelation."""
    port, ref = _port_noise(1), _jax_noise(1)
    assert port.shape == ref.shape == (N_SENSORS, N_SAMPLES)
    se = np.hypot(port.std() / np.sqrt(1300), ref.std() / np.sqrt(1300))
    assert abs(port.mean() - ref.mean()) < 5 * se, (port.mean(), ref.mean(), se)
    assert 0.94 < port.std(ddof=0) / ref.std(ddof=0) < 1.06
    for lag in (1, 5, 15, 45):
        assert abs(_acf(port, lag) - _acf(ref, lag)) < 0.04, lag
    # the lattice is exact at its nodes: the values at every 15th minute are
    # Johnson-SU of an AR(1) chain, whose lag-1 correlation is ~PACF
    nodes = port[:, 14::15]
    assert 0.5 < _acf(nodes, 1) < 0.8


def test_daily_plan_law():
    """tests/test_scenario.py's bands: occurrence rates, times inside the
    truncation bounds in whole minutes, amounts >= 0, the dinner mean; 500
    plans from the port's streams."""
    key = env_keys((3, 4), 500, device="cpu")
    times, amounts = tmeal.draw_daily_plan(key, 0, torch.float64)
    times, amounts = times.numpy(), amounts.numpy()
    occ = times >= 0
    np.testing.assert_allclose(occ.mean(axis=0), [0.95, 0.3, 0.95, 0.3, 0.95, 0.3], atol=0.08)
    lb = np.array([5, 9, 10, 14, 16, 20]) * 60
    ub = np.array([9, 10, 14, 16, 20, 23]) * 60
    for j in range(6):
        tj = times[occ[:, j], j]
        assert tj.min() >= lb[j] - 0.5 and tj.max() <= ub[j] + 0.5
        np.testing.assert_array_equal(tj, np.round(tj))
    assert (amounts[occ] >= 0).all() and (amounts[~occ] == 0).all()
    assert abs(amounts[occ[:, 4], 4].mean() - 80.0) < 2.0


def test_scenario_redraws_at_midnight_and_delivers_its_plan():
    """From 01:00 over two days: one plan a day, a new one after midnight,
    and every meal of the day-0 plan delivered at its minute."""
    B = 16
    key = env_keys(11, B, device="cpu")
    state = tmeal.scenario_init(key, 60, dtype=torch.float64)
    plan_t, plan_a = state.meal_times.numpy().copy(), state.meal_amounts.numpy().copy()
    meals, days, plans = [], [], []
    for t0 in range(0, 2 * 1440, 3):
        state, m = tmeal.scenario_meals_for_step(state, torch.full((B,), t0, dtype=torch.int32), 3,
                                                 dtype=torch.float64)
        meals.append(m)
        days.append(state.day.clone())
        plans.append(state.meal_times.clone())
    meals = torch.stack(meals, 1).reshape(B, -1).numpy()  # minute-wise from 01:00
    days = torch.stack(days, 1).numpy()
    assert set(np.unique(days)) == {0, 1, 2}
    day0 = plans[0].numpy()
    day1 = plans[int(np.argmax(days[0] == 1))].numpy()
    assert not np.array_equal(day0, day1)
    for b in range(B):
        got = {60 + i: float(m) for i, m in enumerate(meals[b, :1380]) if m > 0}
        want = {int(t): float(a) for t, a in zip(plan_t[b], plan_a[b]) if t >= 60 and a > 0}
        assert got == want, b


def test_same_seed_same_streams_other_seeds_other_streams():
    base = _port_noise((5, 6), n=60, batch=8)
    np.testing.assert_array_equal(base, _port_noise((5, 6), n=60, batch=8))
    for other in ((6, 5), (5, 7), (6, 6)):
        assert not np.allclose(base, _port_noise(other, n=60, batch=8)), other
    # a lane's stream does not depend on the batch it runs in
    np.testing.assert_array_equal(base[:4], _port_noise((5, 6), n=60, batch=4))
    plans = lambda seed: tmeal.draw_daily_plan(env_keys(seed, 64, device="cpu"), 0)[0].numpy()
    np.testing.assert_array_equal(plans((1, 2)), plans((1, 2)))
    assert not np.array_equal(plans((1, 2)), plans((2, 1)))


def test_native_cohort_law():
    """simulate_cohort on the eager path with native streams, 30 patients x
    24 h, BB and random meals (chip_smoke.py phase 5's bands for the same
    run on the kernel), and the random initial state's law."""
    res = simulate_cohort(sim_time=timedelta(days=1), engine="xla", scenario_seed=1, cgm_seed=2,
                          device="cpu")
    bg, cgm, cho = res.traj.BG, res.traj.CGM, res.traj.CHO
    assert bg.shape == (480, 30) and np.isfinite(bg).all()
    assert 80.0 < bg.mean() < 250.0 and bg.min() > -1.0 and bg.max() < 600.0
    assert 5.0 < (cgm - bg).std() < 20.0
    assert 160.0 < cho.mean() * 3 * 480 < 280.0
    again = simulate_cohort(sim_time=timedelta(hours=1), engine="xla", scenario_seed=1, cgm_seed=2,
                            device="cpu")
    np.testing.assert_array_equal(again.traj.BG, bg[:20])
    init = simulate_cohort(sim_time=timedelta(hours=1), engine="xla", random_init_bg=True, cgm_seed=2,
                           device="cpu")
    assert not np.array_equal(init.reset.BG, res.reset.BG)
    assert abs(init.reset.BG.mean() / res.reset.BG.mean() - 1) < 0.2
