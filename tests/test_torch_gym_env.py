"""The port's Gymnasium adapters (``simglucose_tpu_torch/envs/gym_env.py``)
on the CPU: the 16 tests of tests/test_gym_env.py at ``device="cpu"`` and
short horizons (where JAX compares by bit under its own keys, by law or
within the port), the registry ids, the ``envs`` exports, ``step_n`` equal
to ``n`` ``step()`` calls bit for bit, and the envs built, reset and stepped
in an interpreter where gymnasium cannot be imported (the card's
machine)."""
import dataclasses
import os
import subprocess
import sys
from datetime import datetime

import numpy as np
import pytest
import torch

import simglucose_tpu.envs as jenvs
import simglucose_tpu_torch.envs as tenvs
from simglucose_tpu_torch.envs import T1DSimGymEnv, T1DSimVectorEnv, register_envs
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.envs.functional import env_reset
from simglucose_tpu_torch.ops.streams import env_keys

gymnasium = pytest.importorskip("gymnasium")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
PORT_ID = "simglucose_tpu_torch/T1DSim-v0"
ENTRY = "simglucose_tpu_torch.envs.gym_env:T1DSimGymEnv"


@pytest.fixture
def registry():
    """Gymnasium's registry, global to the process, restored as it was
    after the test, so that a JAX test in the same worker finds
    ``simglucose-v0`` free for its own entry point (or still its own)."""
    from gymnasium.envs.registration import registry as reg

    before = dict(reg)
    yield reg
    reg.clear()
    reg.update(before)


def test_gym_make_and_run(registry):
    """register -> gym.make by the port's id -> steps (reference:
    tests/test_gym.py:6-35)."""
    register_envs()
    env = gymnasium.make(PORT_ID, patient_name="adolescent#002", seed=3, **CPU)
    obs, info = env.reset()
    assert obs.shape == (1,)
    assert info["patient_name"] == "adolescent#002"
    for _ in range(20):
        act = env.action_space.sample() * 0  # zero basal
        obs, reward, terminated, truncated, info = env.step(act)
        assert obs[0] >= 0
        assert np.isfinite(reward)
        if terminated or truncated:
            obs, info = env.reset()
    env.close()


def test_registry_ids(registry):
    """The port's id is its own; ``simglucose-v0`` is taken only where it
    is free, so a JAX registration of it stands."""
    from gymnasium.envs.registration import register

    for env_id in (PORT_ID, "simglucose-v0"):
        registry.pop(env_id, None)
    register(id="simglucose-v0", entry_point="simglucose_tpu.envs.gym_env:T1DSimGymEnv")
    register_envs()
    register_envs()  # safe to repeat
    assert registry[PORT_ID].entry_point == ENTRY
    assert registry["simglucose-v0"].entry_point == "simglucose_tpu.envs.gym_env:T1DSimGymEnv"
    del registry["simglucose-v0"]
    register_envs()
    assert registry["simglucose-v0"].entry_point == ENTRY


def test_seed_start_time_parity():
    """seed(0) + reset() lands on the reference's 23:00 start (reference:
    tests/test_seed.py:17-21; seed 1000 -> 14:00)."""
    env = T1DSimGymEnv(patient_name="adult#001", seed=0, **CPU)
    env.reset()
    assert env.start_time == datetime(2018, 1, 1, 23, 0, 0)
    env.seed(1000)
    env.reset()
    assert env.start_time == datetime(2018, 1, 1, 14, 0, 0)


def test_different_seeds_different_obs():
    obs = []
    for seed in (0, 1, 2):
        env = T1DSimGymEnv(patient_name="adolescent#001", seed=seed, **CPU)
        o, _ = env.reset(seed=seed)
        obs.append(float(o[0]))
    assert len(set(obs)) == 3


def test_reset_sequence_replays_after_reseed():
    """Successive resets differ; the sequence replays after re-seeding
    (reference: tests/test_reset.py:28-57)."""
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=7, **CPU)
    seq1 = [float(env.reset()[0][0]) for _ in range(3)]
    env.seed(7)
    seq2 = [float(env.reset()[0][0]) for _ in range(3)]
    assert len(set(seq1)) > 1
    assert seq1 == seq2


def test_native_episode_keys_by_seed_pair():
    """A native episode's Philox key is the seed pair (seed3, seed2) of its
    chain, lane 0, episode 0: no mixing of the seeds into one number."""
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=5, **CPU)
    seed2, seed3, _ = env._seeds
    assert env._state.key.tolist() == [seed3, seed2, 0, 0]


def test_custom_reward_fun():
    """A reference-style reward over the BG history (reference:
    tests/test_reward_fun.py:15-48)."""

    def custom_reward(bg_hist):
        bg = bg_hist[-1]
        return torch.where(bg > 180, -1.0, torch.where(bg < 70, -2.0, 1.0))

    env = T1DSimGymEnv(patient_name="adolescent#001", seed=4, reward_fun=custom_reward, **CPU)
    env.reset()
    for _ in range(5):
        _, reward, term, _, _ = env.step(np.asarray([0.01]))
        assert reward in (-1.0, -2.0, 1.0)
        if term:
            break


def test_reward_window_variable_length_at_episode_start():
    """A mean-based 1-argument reward sees only the real CGM history at
    episode start, as the reference's ``CGM_hist[-window:]`` slice does
    (reference: simulation/env.py:100-102)."""

    def mean_reward(bg_hist):
        return torch.mean(bg_hist)

    env = T1DSimGymEnv(patient_name="adolescent#001", seed=11, reward_fun=mean_reward, **CPU)
    env.reset()
    cgm_hist = [env._history[0]["CGM"]]  # reset history sample (env.py:126)
    for _ in range(4):
        _, reward, _, _, _ = env.step(np.asarray([0.01]))
        cgm_hist.append(env._history[-1]["CGM"])
        np.testing.assert_allclose(reward, np.mean(cgm_hist), rtol=1e-6)
        assert abs(reward - np.sum(cgm_hist) / env.cfg.window_size) > 1.0


def test_custom_scenario():
    """A custom meal lands at the requested minute (reference:
    simulation/scenario.py:21-45)."""
    env = T1DSimGymEnv(patient_name="adolescent#001", custom_scenario=[(0.05, 30.0)], seed=1, **CPU)
    env.reset()
    meals = [env.step(np.asarray([0.0]))[4]["meal"] for _ in range(3)]
    # minute 3 is in the second step (minutes 3-5 at Dexcom)
    assert meals[1] > 0 and meals[0] == 0


def test_info_dict_fields():
    env = T1DSimGymEnv(patient_name="child#001", seed=2, **CPU)
    _, info = env.reset()
    for k in ("sample_time", "patient_name", "meal", "patient_state", "time", "bg", "lbgi",
              "hbgi", "risk"):
        assert k in info
    assert info["patient_state"].shape == (13,) and info["patient_state"].dtype == np.float32
    assert isinstance(info["time"], datetime) and info["time"] == env.start_time
    np.testing.assert_array_equal(info["patient_state"], env._state.patient.x.numpy())


def test_show_history():
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=5, **CPU)
    env.reset()
    for _ in range(4):
        env.step(np.asarray([0.01]))
    df = env.show_history()
    assert len(df) == 5  # reset + 4 steps
    assert set(df.columns) >= {"BG", "CGM", "CHO", "insulin", "Risk"}


def test_vector_env():
    env = T1DSimVectorEnv(num_envs=8, seed=0, **CPU)
    obs, info = env.reset()
    assert obs.shape == (8, 1)
    for _ in range(3):
        obs, rew, term, trunc, info = env.step(np.zeros((8, 1)))
        assert obs.shape == (8, 1)
        assert rew.shape == (8,)
        assert np.isfinite(rew).all()


def test_horizon_days_truncates_native_mode():
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=3, horizon_days=9.0 / 1440, **CPU)
    env.reset()
    truncs = []
    for _ in range(3):
        _, _, term, trunc, _ = env.step(np.asarray([0.01]))
        truncs.append(trunc)
        if term:
            return  # terminated before the horizon; nothing to assert
    assert truncs == [False, False, True]


def test_noise_mode_config_authoritative():
    """cfg.noise_mode must agree with EnvParams.noise_seq."""
    cfg, params = make_env("adolescent#001", dtype=torch.float64, **CPU)
    key = env_keys(0, 1, **CPU)[0]
    with pytest.raises(ValueError, match="noise_seq"):
        env_reset(dataclasses.replace(cfg, noise_mode="exogenous"), params, key)
    with pytest.raises(ValueError, match="noise_mode"):
        env_reset(cfg, params._replace(noise_seq=torch.zeros(16, dtype=torch.float64)), key)


def test_vector_env_autoreset_gives_reset_obs():
    """SAME_STEP auto-reset: on termination the returned obs is the new
    episode's reset observation and the terminal step moves to
    info['final_observation'] (reference wrapper: simglucose_gym_env.py:
    48-51)."""
    env = T1DSimVectorEnv(num_envs=4, seed=7, **CPU)
    env.reset()
    action = np.full((4, 1), 30.0, np.float32)  # floods the patients -> hypoglycemia
    for _ in range(400):
        obs, _, term, _, info = env.step(action)
        if term.any():
            for i in range(4):
                if term[i]:
                    fin = info["final_observation"][i]
                    assert fin is not None and fin.shape == (1,)
                    assert info["final_info"][i]["bg"] < 70.0 or info["final_info"][i]["bg"] > 350.0
                    assert obs[i, 0] != fin[0]
                    assert 70.0 < info["bg"][i] < 350.0
                else:
                    assert info["final_observation"][i] is None
            assert (info["_final_observation"] == term).all()
            return
    pytest.fail("expected a termination within 400 max-basal steps")


def test_action_observation_spaces():
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=0, **CPU)
    assert env.action_space.shape == (1,)
    assert float(env.action_space.high[0]) == 30.0  # Insulet max basal
    assert env.observation_space.shape == (1,)
    venv = T1DSimVectorEnv(num_envs=3, **CPU)
    assert venv.action_space.shape == (3, 1) and venv.single_observation_space.shape == (1,)
    assert isinstance(env, gymnasium.Env) and isinstance(venv, gymnasium.vector.VectorEnv)


def test_vector_env_truncation_horizon():
    """truncated fires at the horizon and those lanes auto-reset in the
    same step."""
    env = T1DSimVectorEnv(num_envs=4, seed=1, horizon_days=9.0 / 1440, **CPU)
    assert env.horizon_steps == 3
    env.reset()
    a = np.full((4, 1), 0.01, np.float32)
    flags = []
    for _ in range(4):
        _, _, _, trunc, info = env.step(a)
        flags.append(trunc.copy())
        if trunc.any():
            assert "final_observation" in info
    assert not flags[0].any() and not flags[1].any()
    assert flags[2].all()
    assert not flags[3].any()
    if hasattr(gymnasium.vector, "AutoresetMode"):
        assert env.metadata["autoreset_mode"] == gymnasium.vector.AutoresetMode.SAME_STEP


def test_vector_env_step_n():
    """step_n runs N policy-driven steps, the policy fed the [B, 1] CGM
    tensor, with the auto-reset bookkeeping of step()."""
    B, n = 64, 50
    env = T1DSimVectorEnv(num_envs=B, seed=3, **CPU)
    env.reset()
    seen = []

    def policy(obs):
        seen.append((type(obs), tuple(obs.shape)))
        return torch.full((obs.shape[0], 1), 30.0)

    obs, rew, term, trunc, infos = env.step_n(n, policy)
    assert seen == [(torch.Tensor, (B, 1))] * n
    assert obs.shape == (n, B, 1) and rew.shape == (n, B)
    assert term.shape == (n, B) and trunc.shape == (n, B) and term.dtype == bool
    assert term.any(), "no terminations at max basal?"
    assert np.isfinite(rew).all()
    t, b = np.argwhere(term)[0]
    fin = infos["final_observation"][t, b]
    assert np.isfinite(fin)
    assert infos["final_info"]["bg"][t, b] < 70.0 or infos["final_info"]["bg"][t, b] > 350.0
    assert obs[t, b, 0] != fin
    assert np.isnan(infos["final_observation"][~(term | trunc)]).all()
    obs2, *_ = env.step_n(n, policy)
    assert obs2.shape == (n, B, 1)


def test_step_n_equals_n_steps():
    """step_n(n) is n step() calls from the same reset, bit for bit, through
    terminations and horizon truncations."""
    B, n = 16, 30
    runs = []
    for use_step_n in (True, False):
        env = T1DSimVectorEnv(num_envs=B, seed=9, horizon_days=45.0 / 1440, **CPU)
        env.reset()
        basal = torch.cat([torch.linspace(0.0, 0.05, B // 2), torch.full((B // 2,), 30.0)])[:, None]
        if use_step_n:
            obs, rew, term, trunc, infos = env.step_n(n, lambda o: basal)
            runs.append((obs[:, :, 0], rew, term, trunc, infos["bg"]))
        else:
            steps = [env.step(basal.numpy()) for _ in range(n)]
            runs.append(tuple(np.stack([s[k] for s in steps]) for k in range(4))
                        + (np.stack([s[4]["bg"] for s in steps]),))
    (a_obs, *a_rest), (b_obs, *b_rest) = runs
    np.testing.assert_array_equal(a_obs.astype(np.float32), b_obs[:, :, 0])
    for x, y in zip(a_rest, b_rest):
        np.testing.assert_array_equal(x, y)
    assert runs[0][2].any() and runs[0][3].any()  # both kinds of episode end occurred


def test_render_human_raises():
    env = T1DSimGymEnv(seed=1, render_mode="human", **CPU)
    with pytest.raises(NotImplementedError, match="item 12"):
        env.render()
    assert T1DSimGymEnv(seed=1, **CPU).render() is None


def test_envs_exports():
    assert tenvs.__all__ == jenvs.__all__
    for name in tenvs.__all__:
        assert getattr(tenvs, name) is not None, name
    assert tenvs.T1DSimGymEnv is T1DSimGymEnv and tenvs.register_envs is register_envs


def test_envs_run_without_gymnasium():
    """In an interpreter where gymnasium cannot be imported: both envs
    construct, reset and step (step_n too), reading a space raises
    ImportError naming gymnasium, and register_envs is a no-op."""
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import numpy as np, torch\n"
        "from simglucose_tpu_torch.envs import T1DSimGymEnv, T1DSimVectorEnv, register_envs\n"
        "assert T1DSimVectorEnv.__mro__[1:] == (T1DSimVectorEnv.__mro__[1], object)\n"
        "v = T1DSimVectorEnv(4, horizon_days=0.01, device='cpu')\n"
        "obs, _ = v.reset()\n"
        "obs, rew, term, trunc, info = v.step(np.zeros((4, 1)))\n"
        "o, r, t, tr, infos = v.step_n(6, lambda x: torch.zeros_like(x))\n"
        "assert o.shape == (6, 4, 1) and tr.any()\n"
        "e = T1DSimGymEnv(seed=1, device='cpu')\n"
        "e.reset()\n"
        "e.step(np.zeros(1))\n"
        "for space in ('action_space', 'observation_space'):\n"
        "    for env in (e, v):\n"
        "        try:\n"
        "            getattr(env, space)\n"
        "        except ImportError as err:\n"
        "            assert 'gymnasium' in str(err)\n"
        "        else:\n"
        "            raise AssertionError(space)\n"
        "register_envs()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
