"""Port simulation slice: reward replay vs the JAX package, simulate() on
the plain version against the JAX engine's frame, long-horizon chunking,
and the checks that keep the engine from running anywhere it should not.

simulate(device="cpu") runs the rollout's plain PyTorch version; its noise
comes from the port's own generator, so it meets the JAX engine exactly on
what no generator touches (frame index and columns, the CHO column, the
reset BG) and by law on BG/CGM."""
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.analysis.risk import neg_risk_reward as j_neg_risk
from simglucose_tpu.analysis.risk import risk_diff_reward as j_risk_diff
from simglucose_tpu.envs.functional import rewards_from_cgm as j_rewards_from_cgm
from simglucose_tpu.sim.engine import simulate as jax_simulate
from simglucose_tpu_torch.analysis.risk import neg_risk_reward, risk_diff_reward
from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.envs.functional import (
    replay_rewards,
    reward_history,
    reward_window_size,
    rewards_from_cgm,
)
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.sim import engine

torch.set_num_threads(1)

NAMES = ["adolescent#001", "adult#005", "child#003"]
SCENARIO = [(1, 45), (3.5, 20)]  # (hours since start, grams)


def _span(hist):
    """A reference-style 1-argument reward over the last-hour history; it
    sees only the real samples (window length) at episode start."""
    return -(hist[-1] - hist[0]) / len(hist)


@pytest.mark.parametrize(
    "port_fn,jax_fn", [(risk_diff_reward, j_risk_diff), (neg_risk_reward, j_neg_risk), (_span, _span)]
)
@pytest.mark.parametrize("sample_time", [3, 5])
def test_rewards_from_cgm_matches_jax(port_fn, jax_fn, sample_time):
    """The ring-buffer window replay gives the JAX rewards on the same CGM
    (float64, rtol 1e-12), through window lengths 1..W and past W."""
    rng = np.random.default_rng(sample_time)
    W = reward_window_size(sample_time)
    T, B = W + 5, 4
    cgm0 = rng.uniform(60, 300, B)
    cgm = rng.uniform(60, 300, (T, B))
    got = rewards_from_cgm(port_fn, W, torch.from_numpy(cgm0), torch.from_numpy(cgm))
    ref = j_rewards_from_cgm(jax_fn, W, jnp.asarray(cgm0), jnp.asarray(cgm))
    assert got.shape == (T, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("port_fn", [risk_diff_reward, neg_risk_reward, _span])
@pytest.mark.parametrize("cuts", [(1,), (5, 6), (18, 30), (40,)])
def test_replay_in_pieces_equals_one_piece(port_fn, cuts):
    """Rewards replayed call by call, carrying the window history, equal
    the one-piece replay (float64, rtol 1e-12: torch's CPU log/pow round
    by the call's shape), with cuts inside the filling window and past it."""
    rng = np.random.default_rng(len(cuts))
    W = reward_window_size(3)
    cgm0 = torch.from_numpy(rng.uniform(60, 300, 4))
    cgm = torch.from_numpy(rng.uniform(60, 300, (45, 4)))
    whole = rewards_from_cgm(port_fn, W, cgm0, cgm)
    history, parts = reward_history(W, cgm0), []
    for lo, hi in zip((0,) + cuts, cuts + (45,)):
        r, history = replay_rewards(port_fn, W, history, cgm[lo:hi])
        parts.append(r)
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
    assert history[1] == W - 1 and torch.equal(history[0], cgm[-(W - 1):])


def test_simulate_cpu_custom_scenario_against_jax_frame():
    """Same frame index and columns as the JAX engine, the CHO column
    exactly, the reset row's BG (x0, no random init) and zero CHO/insulin;
    BG/CGM by law; df.attrs['reward'] the risk-diff replay of the frame's
    CGM."""
    kw = dict(sim_time=timedelta(hours=6), scenario=SCENARIO, controller="BB",
              patient_names=NAMES, cgm_seed=3, scenario_seed=2,
              start_time=datetime(2018, 1, 1, 6, 0))
    df = engine.simulate(device="cpu", **kw)
    ref = jax_simulate(engine="xla", **kw)
    assert df.index.equals(ref.index) and list(df.columns) == list(ref.columns)
    np.testing.assert_array_equal(df["CHO"].to_numpy(), ref["CHO"].to_numpy())
    assert df["CHO"].sum() > 0
    reset = df.groupby(level=0).head(1)
    reset_ref = ref.groupby(level=0).head(1)
    np.testing.assert_array_equal(reset["BG"].to_numpy(), reset_ref["BG"].to_numpy())
    assert (reset[["CHO", "insulin"]].to_numpy() == 0).all()
    np.testing.assert_allclose(reset["Risk"].to_numpy(), reset_ref["Risk"].to_numpy(), rtol=2e-6)
    bg, cgm = df["BG"].to_numpy(), df["CGM"].to_numpy()
    assert np.isfinite(bg).all() and 40 < bg.min() and bg.max() < 400
    # BG paths of the two engines stay within a few mg/dL: same physics,
    # same meals and controller, noise of the same law fed back through BB
    assert np.abs(bg - ref["BG"].to_numpy()).max() < 25.0
    assert 2.0 < np.std(cgm - bg) < 40.0
    reward = df.attrs["reward"]
    assert reward.shape == (6 * 60 // 3, len(NAMES))
    cgm_tb = df["CGM"].unstack(level=0)[NAMES].to_numpy().copy()
    replay = rewards_from_cgm(risk_diff_reward, 20, torch.from_numpy(cgm_tb[0]), torch.from_numpy(cgm_tb[1:]))
    np.testing.assert_array_equal(reward, replay.numpy())


def test_long_horizon_chunks_equal_one_call(monkeypatch):
    """A horizon longer than one call runs as calls threading the state and
    equals the single call bit for bit (here with the per-call cap cut to
    17 steps, so a 2-hour run takes calls of 17, 17 and 6 steps)."""
    kw = dict(sim_time=timedelta(hours=2), controller=("PID", dict(P=-2e-4)),
              patient_names=NAMES, cgm_seed=5, random_init_bg=True, device="cpu")
    one = engine.simulate_cohort(**kw)
    calls, calls_cfg = [], []
    real = engine.rollout
    monkeypatch.setattr(engine, "rollout",
                        lambda *a, **k: calls.append(k) or calls_cfg.append(a) or real(*a, **k))
    monkeypatch.setattr(engine, "MAX_STEPS_PER_CALL", 17)
    cut = engine.simulate_cohort(**kw)
    assert [c["init"] for c in calls] == [1, 0, 0]
    assert [c["step_offset"] for c in calls] == [0, 17, 34]
    assert [a[0].n_steps for a in calls_cfg] == [17, 17, 6]
    for a, b in zip(one.traj + one.reset, cut.traj + cut.reset):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one.reward, cut.reward)
    assert one.traj.BG.shape == (40, len(NAMES))


@pytest.mark.parametrize("n", [1, 3])
def test_assembly_keeps_one_piece_and_concatenates_several(n):
    """The calls' pieces as the result: one piece is that very tensor (its
    storage, no copy); several equal ``torch.cat`` along time bit for bit."""
    g = torch.Generator().manual_seed(n)
    pieces = [torch.randn(8, 5 + i, 3, generator=g) for i in range(n)]
    out = engine._assemble(pieces)
    if n == 1:
        assert out is pieces[0] and out.data_ptr() == pieces[0].data_ptr()
    else:
        assert torch.equal(out, torch.cat(pieces, dim=1))
        assert all(out.data_ptr() != p.data_ptr() for p in pieces)


def test_simulate_cohort_shapes_and_save_path(tmp_path):
    """The pandas-free core: [B] reset row and [T, B] planes, finite; the
    frame's save_path writes one CSV per patient and the report."""
    res = engine.simulate_cohort(sim_time=timedelta(hours=1), patient_names=NAMES,
                                 cgm_name="GuardianRT", device="cpu")
    assert res.sample_time == 5 and res.traj.BG.shape == (12, 3) and res.reset.BG.shape == (3,)
    assert all(np.isfinite(a).all() for a in res.traj + res.reset)
    engine.simulate(sim_time=timedelta(minutes=30), patient_names=NAMES[:1], device="cpu",
                    save_path=str(tmp_path))
    assert (tmp_path / "adolescent#001.csv").exists()
    assert (tmp_path / "performance_stats.csv").exists()


def test_cuda_requests_raise_without_running_on_cpu(monkeypatch):
    """device='cuda' where there is no CUDA raises before any rollout: no
    hidden fallback to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    monkeypatch.setattr(tr, "rollout_reference", lambda *a, **k: pytest.fail("ran on the CPU"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.simulate_cohort(sim_time=timedelta(hours=1), patient_names=NAMES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.simulate(sim_time=timedelta(hours=1), patient_names=NAMES, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_device("cuda")
    # a tensor on neither the CPU nor a CUDA card is refused, not moved
    p = engine.tables.load_patient_params(engine.tables.cohort_names(128), device="cpu")
    packed = tr.pack_params(p, engine.basal_rate(p)).to("meta")
    with pytest.raises(ValueError, match="'cpu' or 'cuda' tensors"):
        tr.rollout(tr.RolloutConfig(n_steps=2), packed)
    assert tr.LAUNCHES["rollout"] == 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(controller=(lambda: None, lambda *a: None)),
        dict(compat_mode=True, cgm_seed=1, scenario_seed=1),
        dict(dtype=np.float64),
        dict(substeps=2),
        dict(animate=True),
        dict(engine="xla"),
    ],
)
def test_configs_for_the_general_engine_raise(kw):
    """What the JAX package sends to its XLA engine runs on the port's eager
    env path; animate=True runs the engine the config takes in one-hour
    calls and draws after each (matplotlib's Agg backend here).  A
    controller that is no controller fails as it would in the JAX engine,
    with a TypeError from its own call."""
    run = lambda: engine.simulate_cohort(sim_time=timedelta(hours=1), patient_names=NAMES,
                                         device="cpu", **kw)
    if kw.get("animate"):
        import matplotlib

        matplotlib.use("Agg")
        res = run()
        assert res.traj.BG.shape == (20, 3) and np.isfinite(res.traj.BG).all()
    elif "controller" in kw:
        with pytest.raises(TypeError):
            run()
    else:
        res = run()
        assert res.traj.BG.shape == (20, 3) and np.isfinite(res.traj.BG).all()
