"""The port's benches and profilers (``simglucose_tpu_torch/tools/``) at
tiny sizes on the CPU (the kernels' plain versions), against the JAX tools
of the same names: each prints its JSON line last, with the JAX tool's
keys (for ``profile_fused_ppo``, whose JAX tool prints text rows, the
row names; for ``bench_xla_paths`` the variant names of the JAX tool's
lines), and the variants on ROADMAP's "Not ported" list appear as not
ported, not measured.

``bench_scaling`` spawns two gloo ranks once and counts the collectives of
each path exactly: none in the sharded rollout; in the data-parallel
'step' learner one all-reduce of the minibatches' advantage statistics
(2 x minibatches float32 sums) and one per minibatch of the gradients
and the two loss sums; in a fused mesh iteration one more, of the metrics.
"""
import json

import pytest
import torch

from simglucose_tpu_torch.tools import (
    bench_ppo,
    bench_ppo_fused,
    bench_scaling,
    bench_xla_paths,
    profile_fused_ppo,
    profile_xla_path,
)

torch.set_num_threads(1)

FUSED = dict(batch=128, rollout_steps=8, hidden=16, device="cpu")
PROFILE_ROWS = {"rollout (kernel only)", "rollout+forward+GAE", "full (e=2, mb=4)",
                "full pallas learner (plane prep)", "kprep rollout (emit rows)",
                "kprep rollout+GAE", "kprep full"}
BENCH_KEYS = {"metric", "value", "unit", "iters_per_sec", "batch", "rollout_steps"}

RUNS = {
    "bench_ppo_fused": (lambda: bench_ppo_fused.main(n_iters=2, **FUSED),
                        BENCH_KEYS, dict(metric="fused_ppo_env_steps_per_sec", batch=128)),
    "bench_ppo": (lambda: bench_ppo.main(batch=16, rollout_steps=4, n_iters=1, hidden=16,
                                         device="cpu"),
                  BENCH_KEYS, dict(metric="ppo_env_steps_per_sec", rollout_steps=4)),
    "profile_fused_ppo_quick": (lambda: profile_fused_ppo.main(["quick"], iters=1, **FUSED),
                                PROFILE_ROWS | {"kprep full t_chunk=4", "kprep full t_chunk=16"},
                                {}),
    "bench_xla_paths": (lambda: bench_xla_paths.main([], batch=16, steps=4, n_calls=1,
                                                     device="cpu"),
                        {"fixed_streaming", "fixed_pregen", "autoreset", "autoreset_K16",
                         "autoreset_K64"}, {}),
    "profile_xla_path": (lambda: profile_xla_path.main(batch=16, steps=4, n_calls=1,
                                                       device="cpu"),
                         {"base", "noise_off", "scen_none", "both_off", "fixedhz"}, {}),
}
NOT_PORTED = {"fixed_pregen", "autoreset_K16", "autoreset_K64", "kprep full t_chunk=4",
              "kprep full t_chunk=16"}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tool_prints_the_jax_tools_keys(name, capsys):
    run, keys, values = RUNS[name]
    out = run()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and set(printed) == keys
    for k, v in values.items():
        assert printed[k] == v, k
    for k, v in printed.items():
        if k in NOT_PORTED:
            assert v.startswith("not ported: ") and "ROADMAP" in v, (k, v)
        elif k not in ("metric", "unit"):
            assert isinstance(v, (int, float)) and v > 0, (k, v)


def test_profile_fused_ppo_grid_rows(capsys):
    rows = profile_fused_ppo.main([], iters=1, **FUSED)
    assert set(rows) == PROFILE_ROWS | {"kprep full t_chunk=4", "kprep full t_chunk=16",
                                        "full (e=1, mb=4)", "full (e=2, mb=1)",
                                        "full (e=1, mb=1)"}
    assert "-> minimal learner (1 step)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def scaling():
    return bench_scaling.run_ranks(2, device="cpu")


def test_bench_scaling_counts_the_collectives(scaling):
    cfg = bench_scaling.LEARNER_CFG
    n_mb = cfg["epochs"] * cfg["minibatches"]
    n_params = 7 * 64 + 64 + 64 * 64 + 64 + 64 + 1 + 1 + 64 + 1
    assert scaling["policy_params"] == n_params
    assert scaling["rollout"] == []
    stats = {"op": "all_reduce", "bytes": 2 * cfg["minibatches"] * 4}
    grads = {"op": "all_reduce", "bytes": (n_params + 2) * 4}
    assert scaling["learner"] == [stats] + [grads] * n_mb
    assert scaling["fused_step"] == [{"op": "all_reduce", "bytes": 2 * 4}, stats] + [grads] * n_mb


def test_bench_scaling_main_prints_the_record(monkeypatch, capsys, scaling):
    monkeypatch.setattr(bench_scaling, "run_ranks", lambda n, device, backend: scaling)
    out = bench_scaling.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert lines[0] == "rollout (dp=2): 0 collectives: none"
