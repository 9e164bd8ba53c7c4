"""Port rollout K1a on its stochastic paths, and its Philox generator.

The port draws its randomness from Philox-4x32-10 (key = the two seeds,
counter = patient, global step, draw site), not from the JAX kernel's TPU
generator, so stochastic configs are held to the JAX kernel's laws and
bands (tests/test_pallas_rollout.py), not to its bits.  Within the port
the generator is exact: a horizon cut into calls equals the single call bit
for bit."""
import dataclasses
import math

import pytest
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.ops.philox import philox4x32, philox_words, uniform

torch.set_num_threads(1)

B = 128


def _packed():
    p = tables.load_patient_params(tables.cohort_names(B), device="cpu")
    return tr.pack_params(p, basal_rate(p))


def test_static_scenario_native_noise_law():
    """scenario_kind='static' with the port's own noise (random init BG, no
    autoreset): meals are exact, the CGM-BG residual has the Johnson-SU
    scale (JAX band: std in (2, 40))."""
    T = 6
    cfg = tr.RolloutConfig(
        n_steps=T, scenario_kind="static", autoreset=False, random_init_bg=True,
        fixed_start_min=0, controller="pid", det_meal_times=(3, 12), det_meal_amounts=(30.0, 25.0),
    )
    traj = tr.rollout(cfg, _packed(), 5)
    expect = torch.zeros(T)
    expect[1] = 10.0  # 30 g announced over the 3-min step holding minute 3
    expect[4] = 25.0 / 3.0  # minute 12 -> step 4
    torch.testing.assert_close(traj["CHO"], expect[:, None].expand(T, B), rtol=1e-6, atol=0)
    resid = traj["CGM"] - traj["BG"]
    assert 2.0 < resid.std(correction=0) < 40.0
    assert torch.isfinite(traj["BG"]).all()


def test_stochastic_law_with_autoreset():
    """The default config (random meals, noise, random init BG and start
    hour, autoreset) over one simulated day, held to the JAX kernel's law
    bands; the same seed reproduces bit for bit, a neighbouring seed does
    not, episodes terminate and restart."""
    T = 480
    cfg = tr.RolloutConfig(n_steps=T, controller="pid")
    packed = _packed()
    traj = tr.rollout(cfg, packed, 7)
    bg = traj["BG"]
    assert torch.isfinite(bg).all()
    assert 60 < bg.mean() < 250
    cho_per_day = traj["CHO"].mean() * cfg.sample_time * 480
    assert 40 < cho_per_day < 500
    assert 1.0 < (traj["CGM"] - bg).std(correction=0) < 40.0
    assert traj["done"].any(), "some episodes must end in a day"
    assert torch.unique(traj["BG0"]).numel() > B // 2  # random init BG
    short = dataclasses.replace(cfg, n_steps=16)
    bg16 = tr.rollout(short, packed, 7)["BG"]
    assert torch.equal(bg16, bg[:16])
    assert not torch.equal(tr.rollout(short, packed, 8)["BG"], bg16)


@pytest.mark.parametrize("autoreset", [False, True])
def test_chunked_equals_single_call(autoreset):
    """A horizon cut into two calls threading the state (the second passes
    step_offset) equals the single call bit for bit, with every draw site
    live: noise, random init BG, a midnight meal-plan redraw inside the
    second call (start 23:00), and auto-reset draws."""
    packed = _packed()
    common = dict(controller="pid", autoreset=autoreset, fixed_start_min=23 * 60,
                  bg_done_high=180.0 if autoreset else 350.0)
    key = (13, 4)
    single = tr.rollout(tr.RolloutConfig(n_steps=40, **common), packed, key)
    half = tr.RolloutConfig(n_steps=20, **common)
    a = tr.rollout(half, packed, key)
    b = tr.rollout(half, packed, key, state=(a["state_f"], a["state_i"]), init=0, step_offset=20)
    for k in ("BG", "CGM", "CHO", "insulin", "reward", "done"):
        assert torch.equal(torch.cat([a[k], b[k]]), single[k]), k
    assert torch.equal(b["state_f"], single["state_f"])
    assert torch.equal(b["state_i"], single["state_i"])
    assert torch.equal(a["BG0"], single["BG0"]) and torch.equal(a["CGM0"], single["CGM0"])
    day = single["state_i"][2]
    if autoreset:
        assert single["done"].any() and (day == 1).any()
    else:
        assert (day == 1).all(), "every lane crossed midnight"


# Philox-4x32-10 known-answer vectors (Salmon et al., SC'11, Random123 kat_vectors)
_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expect", _KAT)
def test_philox_known_answers(ctr, key, expect):
    got = philox4x32(*(torch.tensor([c]) for c in ctr), *key)
    assert [int(w) for w in got] == list(expect)


def test_philox_streams():
    """Deterministic; adjacent seeds, patients and steps give unrelated
    streams; the uniforms have U(0,1) moments; a stream depends only on its
    counter, so where a horizon is cut cannot change it."""
    n = 1 << 16
    w = philox_words(n, (5, 9), 3, 1, device="cpu")
    assert torch.equal(w, philox_words(n, (5, 9), 3, 1, device="cpu"))
    for other in (philox_words(n, (6, 9), 3, 1, device="cpu"), philox_words(n, (5, 10), 3, 1, device="cpu"),
                  philox_words(n, (5, 9), 4, 1, device="cpu"), philox_words(n, (5, 9), 3, 2, device="cpu")):
        assert (other == w).float().mean() < 1e-3
    # patient i+1 of one call is patient i shifted: no aliasing across lanes
    assert (w[1:] == w[:-1]).float().mean() < 1e-3
    u = uniform(w.reshape(-1)).double()
    # 4n uniforms: mean 1/2 and variance 1/12 within 5 standard errors
    m = u.numel()
    assert abs(u.mean().item() - 0.5) < 5 * math.sqrt(1 / 12 / m)
    assert abs(u.var(correction=0).item() - 1 / 12) < 5 * math.sqrt(1 / 180 / m)
    assert u.min() >= 1e-7 and u.max() < 1.0
    # the words of counters (i, step) do not depend on the other counters
    # drawn beside them
    part = philox4x32(torch.arange(100, 200), 3, 1, 0, 5, 9)
    assert torch.equal(torch.stack(part, 1), w[100:200])
