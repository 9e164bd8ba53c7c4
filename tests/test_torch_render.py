"""Live rendering of the port against the JAX package, on matplotlib's Agg
backend.

* ``analysis/rendering.py::Viewer`` against the JAX ``Viewer`` on
  tests/test_render.py's frame, replayed in growing slices and then with a
  BG spike and a time crossing: after every ``render`` each axis of the two
  viewers has the same line data and the same x and y limits (equal, the
  same arithmetic on the same float64 frame).
* ``simulate(animate=True)`` equals ``animate=False`` bit for bit on the
  CPU, on the rollout kernel's plain version and on the eager env path; the
  live plots are drawn after each one-hour call, for the first four
  patients, the last drawing holding the whole horizon.
* a compat-mode ``T1DSimGymEnv(render_mode='human')`` episode against the
  JAX env's: the Viewers' lines at tests/test_torch_gym_parity.py's
  tolerances (BG rtol 5e-8, CGM atol 1e-5, CHO and insulin rtol 1e-12,
  the risk lines rtol 1e-5); the 1e-9 of PR 11 holds the card's compat
  episode to the CPU's, not to JAX.
"""
import matplotlib

matplotlib.use("Agg")

from datetime import datetime, timedelta  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from simglucose_tpu.analysis import rendering as jrendering  # noqa: E402
from simglucose_tpu.envs.gym_env import T1DSimGymEnv as JGymEnv  # noqa: E402
from simglucose_tpu_torch.analysis import rendering as trendering  # noqa: E402
from simglucose_tpu_torch.envs.gym_env import T1DSimGymEnv  # noqa: E402
from simglucose_tpu_torch.sim import engine  # noqa: E402

torch.set_num_threads(1)

T0 = datetime(2018, 1, 1)


def _frame(n, seed=0, bg_hi=200.0):
    """tests/test_render.py's frame."""
    rng = np.random.RandomState(seed)
    return pd.DataFrame(
        {
            "BG": rng.uniform(90, bg_hi, n),
            "CGM": rng.uniform(90, bg_hi, n),
            "CHO": np.zeros(n),
            "insulin": np.full(n, 0.01),
            "LBGI": np.zeros(n),
            "HBGI": rng.uniform(0, 3, n),
            "Risk": rng.uniform(0, 3, n),
        },
        index=pd.Index([T0 + timedelta(minutes=3 * i) for i in range(n)], name="Time"),
    )


def _axes_state(viewer):
    out = []
    for ax in viewer.axes:
        lines = [(np.asarray(mlines.get_xdata(), dtype=object), np.asarray(mlines.get_ydata()))
                 for mlines in ax.get_lines()]
        out.append((lines, ax.get_xlim(), ax.get_ylim()))
    return out


def _assert_same_axes(a, b, tol=None):
    for (la, xa, ya), (lb, xb, yb) in zip(_axes_state(a), _axes_state(b)):
        assert xa == xb and len(la) == len(lb)
        if tol is None:
            assert ya == yb
        for (xda, yda), (xdb, ydb) in zip(la, lb):
            assert list(xda) == list(xdb)
            if tol is None:
                np.testing.assert_array_equal(yda, ydb)


def test_viewer_matches_jax_after_every_render():
    df = _frame(30)
    spiked = _frame(20, seed=1)
    spiked.loc[spiked.index[5], "BG"] = 500.0
    frames = [df.iloc[:i] for i in range(1, 30, 7)] + [spiked, _frame(int((6 * 60 - 20) / 3), 2)]
    jv, tv = jrendering.Viewer(T0, "adolescent#001"), trendering.Viewer(T0, "adolescent#001")
    for f in frames:
        jv.render(f)
        tv.render(f)
        _assert_same_axes(tv, jv)
    assert tv.axes[0].get_ylim()[1] >= 500.0 * 1.1 - 1e-6  # the spike widened the window
    tv.close()
    jv.close()
    assert tv.fig is None


NAMES = ["adolescent#001", "adult#005", "child#003", "adult#001", "child#009"]


@pytest.mark.parametrize("engine_name, hours", [("pallas", 3.5), ("xla", 2.0)])
def test_animate_equals_the_unanimated_run(monkeypatch, engine_name, hours):
    drawn = []
    real = trendering.Viewer.render

    def spy(self, df):
        drawn.append((self.patient_name, len(df)))
        return real(self, df)

    monkeypatch.setattr(trendering.Viewer, "render", spy)
    kw = dict(sim_time=timedelta(hours=hours), patient_names=NAMES, engine=engine_name,
              cgm_seed=4, scenario_seed=2, device="cpu")
    plain = engine.simulate_cohort(**kw)
    assert drawn == []
    live = engine.simulate_cohort(animate=True, **kw)
    for a, b in zip(live.traj + live.reset + (live.reward,),
                    plain.traj + plain.reset + (plain.reward,)):
        np.testing.assert_array_equal(a, b)
    n = int(hours * 60) // 3
    calls = -(-n // 20)  # one-hour calls of 20 Dexcom steps
    assert len(drawn) == 4 * calls
    assert drawn[:4] == [(name, 21) for name in NAMES[:4]]  # the reset row and one hour
    assert drawn[-4:] == [(name, n + 1) for name in NAMES[:4]]


def test_simulate_frame_with_animate_is_the_unanimated_frame():
    kw = dict(sim_time=timedelta(hours=2), patient_names=NAMES[:2], device="cpu")
    pd.testing.assert_frame_equal(engine.simulate(animate=True, **kw), engine.simulate(**kw))


def test_compat_episode_renders_as_the_jax_env():
    kw = dict(patient_name="adolescent#001", seed=0, compat_mode=True, horizon_days=1,
              render_mode="human")
    envs = {"jax": JGymEnv(**kw), "port": T1DSimGymEnv(device="cpu", **kw)}
    for env in envs.values():
        env.reset()
    for k in range(12):
        for env in envs.values():
            env.step(np.asarray([0.01 + 0.001 * (k % 5)]))
            if k % 4 == 3:
                env.render()
        if k % 4 == 3:
            jv, tv = envs["jax"]._viewer, envs["port"]._viewer
            _assert_same_axes(tv, jv, tol="stated")
            (jbg, jcgm), (tbg, tcgm) = ([l.get_ydata() for l in v.axes[0].get_lines()]
                                        for v in (jv, tv))
            np.testing.assert_allclose(tbg, jbg, rtol=5e-8)
            np.testing.assert_allclose(tcgm, jcgm, rtol=0, atol=1e-5)
            for i, rtol in ((1, 1e-12), (2, 1e-12)):
                np.testing.assert_allclose(tv.axes[i].get_lines()[0].get_ydata(),
                                           jv.axes[i].get_lines()[0].get_ydata(), rtol=rtol)
            for tl, jl in zip(tv.axes[3].get_lines(), jv.axes[3].get_lines()):
                np.testing.assert_allclose(tl.get_ydata(), jl.get_ydata(), rtol=1e-5, atol=1e-10)
    for env in envs.values():
        env.close()
    assert envs["port"]._viewer is None
