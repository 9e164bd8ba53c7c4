"""The port's bench (``simglucose_tpu_torch/tools/bench.py`` and
``tools/bench_pallas.py``) on the CPU, against the root ``bench.py``.

* The law gate: ``_check_laws`` and ``_assert_band`` give the JAX bench's
  verdict on the six violations of ``tests/test_bench_laws.py`` and at
  each band's ``lo`` and ``hi`` and one float32 ulp outside each, for the
  headline and both sensors; the band tables are equal.
* ``_law_stats`` against ``bench._law_stats`` on a seeded trajectory with
  a residual mean far from 0, within 1e-6 relative, with no mesh and with
  a one-rank mesh (the float64 sums, then the squared deviations from the
  mean, both summed over the ranks).  The residual std is the population
  std (ddof 0): at 128 samples ddof 1 is 0.4% larger.
* ``bench_pallas`` on the plain version at B=128, T=160 (about the
  smallest shape whose law stats sit inside the headline's bands), and a
  clamped-BG trajectory failing it; the timed loop's keys; the fused PPO
  and general-path sections at their smallest shapes; ``main``'s line
  with its sections cut to those shapes (JAX's keys, read from
  ``bench.py``'s ``main``, plus ``device`` and ``power_limit``) and its
  lack of any fallback; both entry points raise
  without CUDA; ``bench_pallas``'s TPU knobs are a usage error.
* The card label: the bench's ``device`` / ``power_limit``, the roofline
  tool's card and SM clock and ``chip_smoke.py``'s card line ask
  ``nvidia-smi`` by the timed card's UUID (``subprocess.run`` and the
  device properties stubbed).
"""
import ast
import functools
import inspect
import json
import os

import numpy as np
import pytest
import torch

import bench as jbench
from simglucose_tpu_torch.parallel.sharding import LOCAL
from simglucose_tpu_torch.tools import bench as tbench
from simglucose_tpu_torch.tools import bench_pallas as tbench_pallas

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD = {"bg_mean": 203.8, "done_rate": 0.0080, "resid_std": 11.47, "cho_per_day": 220.0}
HEADLINE = dict(batch=128, n_steps=160, n_calls=1)
PPO = dict(batch=1024, rollout_steps=8, hidden=16)


def _verdict(fn, *args):
    try:
        fn(*args)
    except AssertionError as e:
        assert "law violation" in str(e)
        return False
    return True


def test_sensor_band_tables_are_the_jax_benchs():
    assert tbench._SENSOR_GATE_BANDS == jbench._SENSOR_GATE_BANDS


def test_good_stats_pass_both():
    assert _verdict(tbench._check_laws, dict(GOOD)) and _verdict(jbench._check_laws, dict(GOOD))


@pytest.mark.parametrize("key,bad", [("bg_mean", 39.0), ("bg_mean", 400.0), ("done_rate", 0.0),
                                     ("resid_std", 0.0), ("resid_std", 50.0),
                                     ("cho_per_day", 0.0)])
def test_violations_fail_both(key, bad):
    stats = dict(GOOD, **{key: bad})
    assert not _verdict(tbench._check_laws, stats)
    assert not _verdict(jbench._check_laws, stats)


def _edges(lo, hi):
    """(value, accepted): each bound, and one float32 ulp outside it."""
    f = np.float32
    return [(lo, True), (hi, True), (float(np.nextafter(f(lo), f(-np.inf))), False),
            (float(np.nextafter(f(hi), f(np.inf))), False)]


BAND_CASES = [("headline", k) for k in GOOD] + [(s, k) for s in ("GuardianRT", "Navigator")
                                                for k in GOOD]


@pytest.mark.parametrize("which,key", BAND_CASES)
def test_band_edges(which, key):
    if which == "headline":
        lo, hi = tbench._LAW_BANDS[key]
        for value, accepted in _edges(lo, hi):
            stats = dict(GOOD, **{key: value})
            assert _verdict(tbench._check_laws, stats) is accepted, (key, value)
            assert _verdict(jbench._check_laws, stats) is accepted, (key, value)
        return
    lo, hi = tbench._SENSOR_GATE_BANDS[which][key]
    for value, accepted in _edges(lo, hi):
        name = f"{which}.{key}"
        assert _verdict(tbench._assert_band, name, value, lo, hi) is accepted, (name, value)
        assert _verdict(jbench._assert_band, name, value,
                        *jbench._SENSOR_GATE_BANDS[which][key]) is accepted, (name, value)


def _trajectory(T=16, B=8, seed=0):
    rng = np.random.default_rng(seed)
    bg = (200.0 + 30.0 * rng.standard_normal((T, B))).astype(np.float32)
    return {
        "BG": bg,
        # a residual mean far from 0: a one-pass E[x^2] - E[x]^2 loses it
        "CGM": (bg + 40.0 + 11.5 * rng.standard_normal((T, B))).astype(np.float32),
        "done": rng.random((T, B)) < 0.1,
        "CHO": (rng.random((T, B)) * 2.0).astype(np.float32),
    }


@pytest.mark.parametrize("form", ["local", "mesh"])
@pytest.mark.parametrize("sample_time", [1, 3, 5])
def test_law_stats_match_the_jax_bench(form, sample_time):
    traj = _trajectory()
    want = {k: float(v) for k, v in jbench._law_stats(traj, sample_time).items()}
    port = {k: torch.from_numpy(v) for k, v in traj.items()}
    got = tbench._law_stats(port, sample_time, None if form == "local" else LOCAL)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.ndim == 0
        assert abs(float(v) - want[k]) <= 1e-6 * abs(want[k]), (k, float(v), want[k])


def test_timed_rounds_keys_and_last_trajectory():
    """Call i of round r at key (r * n_calls + i + 1, 0), after one warm-up
    call at key (0, 0); the last call's trajectory is returned."""
    seeds = []

    def run(seed):
        seeds.append(seed)
        return {"reward": torch.full((2, 8), float(seed[0]))}

    rate, traj = tbench._timed_rounds(run, 8, 2, 3, 2, "cpu")
    assert seeds == [(i, 0) for i in range(7)]
    assert float(traj["reward"][0, 0]) == 6.0 and rate > 0


def test_round_seconds_warms_up_then_times_each_round():
    """One untimed call, then one timed call a round; without a mesh each
    round's seconds are this process's own."""
    calls = []
    seconds = tbench._round_seconds(lambda: calls.append(len(calls)), 3, "cpu")
    assert calls == [0, 1, 2, 3]
    assert len(seconds) == 3 and all(np.isfinite(s) and s >= 0 for s in seconds)


def test_bench_pallas_plain_version():
    rate, stats = tbench.bench_pallas(**HEADLINE, device="cpu")
    assert np.isfinite(rate) and rate > 0
    for k, (lo, hi) in tbench._LAW_BANDS.items():
        assert lo <= stats[k] <= hi, (k, stats[k])


def test_clamped_bg_fails_the_bench(monkeypatch):
    from simglucose_tpu_torch.ops import rollout as tr

    def clamped(cfg, packed, seed, **kw):
        T, B = cfg.n_steps, packed.shape[1] * packed.shape[2]
        g = torch.Generator().manual_seed(seed[0])
        bg = torch.full((T, B), 39.0)
        return {"BG": bg, "CGM": bg + 11.0 * torch.randn(T, B, generator=g),
                "done": torch.rand(T, B, generator=g) < 0.008,
                "CHO": torch.full((T, B), 220.0 / 1440.0), "reward": torch.zeros(T, B)}

    monkeypatch.setattr(tr, "rollout", clamped)
    with pytest.raises(AssertionError, match="law violation: bg_mean"):
        tbench.bench_pallas(batch=128, n_steps=16, n_calls=1, device="cpu")


def test_fused_ppo_and_general_path_sections():
    sps, ips = tbench.bench_fused_ppo(**PPO, iters=1, device="cpu")
    assert np.isfinite([sps, ips]).all() and ips > 0
    assert sps == pytest.approx(ips * 1024 * 8, rel=1e-12)
    xla = tbench.bench_xla(batch=16, n_steps=4, n_calls=1, device="cpu")
    assert np.isfinite(xla) and xla > 0


def _jax_keys():
    """The keys the JAX bench's ``main`` prints on its kernel path."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys - {"fused_ppo_error"}


def _cut(monkeypatch, name, **sizes):
    monkeypatch.setattr(tbench, name, functools.partial(getattr(tbench, name), **sizes))


def test_main_prints_the_jax_benchs_line(monkeypatch, capsys):
    _cut(monkeypatch, "bench_pallas", batch=128)
    _cut(monkeypatch, "law_gate_other_sensors", batch=128, n_steps=288)
    _cut(monkeypatch, "bench_fused_ppo", **PPO)
    monkeypatch.setattr(tbench, "PPO_B", PPO["batch"])
    monkeypatch.setattr(tbench, "PPO_T", PPO["rollout_steps"])
    out = tbench.main([], n_steps=160, n_calls=1, ppo_iters=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == out
    assert len(_jax_keys()) == 9
    assert set(printed) == _jax_keys() | {"device", "power_limit"}
    assert printed["path"] == "cuda" and printed["device"] == "cpu"
    assert printed["power_limit"] is None
    assert printed["fused_ppo_batch"] == 1024 and printed["fused_ppo_rollout_steps"] == 8
    assert printed["vs_baseline"] == round(printed["value"] / 1e6, 3)


@pytest.mark.parametrize("error", [RuntimeError, AssertionError])
def test_main_has_no_fallback(monkeypatch, capsys, error):
    """A failing fused section fails the bench: no line, no error key."""
    def fail(*args, **kw):
        raise error("fused section failed")

    monkeypatch.setattr(tbench, "bench_pallas", lambda *a, **kw: (1.0e6, {}))
    monkeypatch.setattr(tbench, "law_gate_other_sensors", lambda *a, **kw: {})
    monkeypatch.setattr(tbench, "bench_fused_ppo", fail)
    with pytest.raises(error, match="fused section failed"):
        tbench.main([], device="cpu")
    assert capsys.readouterr().out == ""


def test_main_general_path_on_request(monkeypatch, capsys):
    _cut(monkeypatch, "bench_xla", batch=16, n_steps=4)
    out = tbench.main(["--path", "xla"], xla_calls=1, device="cpu")
    assert json.loads(capsys.readouterr().out) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "path", "device", "power_limit"}
    assert out["path"] == "xla" and out["value"] > 0


@pytest.mark.parametrize("entry", ["bench", "bench_pallas"])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr("sys.argv", [entry])
    main = tbench.main if entry == "bench" else tbench_pallas.main
    if torch.cuda.is_available():
        assert inspect.signature(main).parameters["device"].default == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()


def test_bench_pallas_tool_refuses_tpu_knobs(capsys):
    with pytest.raises(SystemExit) as e:
        tbench_pallas.main(["4096", "256", "32"], device="cpu")
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "block_rows, t_chunk and regen_every" in err and "no counterpart" in err


def test_bench_pallas_tool_reads_n_calls(monkeypatch, capsys):
    seen = {}

    def rounds(run, batch, n_steps, n_calls, rounds, device):
        seen.update(batch=batch, n_steps=n_steps, n_calls=n_calls, rounds=rounds)
        return 2.5e6, None

    monkeypatch.setenv("N_CALLS", "3")
    monkeypatch.setattr(tbench, "_timed_rounds", rounds)
    assert tbench_pallas.main(["128", "16"], device="cpu") == 2.5e6
    assert seen == dict(batch=128, n_steps=16, n_calls=3, rounds=1)
    assert capsys.readouterr().out == "pallas B=128 T=16: 2.50M env-steps/s\n"
    monkeypatch.delenv("N_CALLS")
    tbench_pallas.main([], device="cpu")
    assert seen == dict(batch=4096, n_steps=256, n_calls=24, rounds=1)


def _stub_cards(monkeypatch, current=0):
    """Four cards, each with its UUID; ``subprocess.run`` answers a query
    by UUID with that card's line, fails on any other ``-i`` (an index
    means nothing to it) and records every ``-i`` argument."""
    import subprocess
    import types

    uuids = [f"0000000{k}-aaaa-bbbb-cccc-ddddeeeeffff" for k in range(4)]
    asked = []

    def run(cmd, **kw):
        i = cmd[cmd.index("-i") + 1]
        asked.append(i)
        k = [f"GPU-{u}" for u in uuids].index(i)
        line = f"1{k}50" if "clocks.sm" in " ".join(cmd) else f"card {k}, {100 * (k + 1)}.00 W"
        return types.SimpleNamespace(stdout=line + "\n", returncode=0)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda k: types.SimpleNamespace(uuid=uuids[k]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    return asked


@pytest.mark.parametrize("index", [0, 2, 3])
def test_card_label_asks_by_uuid(monkeypatch, index):
    """The bench's ``device`` / ``power_limit``, the roofline tool's card
    and SM clock, and ``chip_smoke.py``'s card line name the card torch
    times: ``nvidia-smi -i GPU-<uuid>`` of ``get_device_properties(k)``,
    never torch's index (which need not be ``nvidia-smi``'s)."""
    import importlib.util

    from simglucose_tpu_torch.tools import roofline_rollout

    asked = _stub_cards(monkeypatch, current=index)
    uuid = f"GPU-0000000{index}-aaaa-bbbb-cccc-ddddeeeeffff"
    assert tbench._card(torch.device("cuda", index)) == (f"card {index}", f"{100 * (index + 1)}.00 W")
    assert tbench._card(torch.device("cuda")) == (f"card {index}", f"{100 * (index + 1)}.00 W")
    assert roofline_rollout.nvidia_smi() == f"card {index}, {100 * (index + 1)}.00 W"
    assert roofline_rollout.sm_clock_mhz() == float(f"1{index}50")
    spec = importlib.util.spec_from_file_location("chip_smoke_labels", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.nvidia_smi() == cs.nvidia_smi(index) == f"card {index}, {100 * (index + 1)}.00 W"
    assert asked == [uuid] * 6
    assert tbench._card(torch.device("cpu")) == ("cpu", None)
