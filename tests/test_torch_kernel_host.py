"""The CUDA kernel's per-patient math, built for the host, vs the plain
version.

csrc/rollout_math.cuh holds everything one CUDA thread computes as
__host__ __device__ functions.  Here it is compiled by g++ (no FMA
contraction) behind a small C loop over patients and run on the CPU
against :func:`rollout_reference`, through the same by-value config struct
the CUDA launcher takes.  The Philox draws are the same bits, so even the
stochastic configs agree lane for lane; only libm's and PyTorch's
transcendentals differ in their last bits.  Tolerances: BG/CGM rtol 2e-6,
reward atol 1e-4, CHO/insulin/done and the int state exact, the float
state rtol 2e-6 with an absolute floor of 2e-6 of each plane's largest
magnitude (cancellation in the PID integral and near-zero states).  Where
the card's own arithmetic (FMA, CUDA's libm) moves these, chip_smoke.py
states its tolerances."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import build
from simglucose_tpu_torch.ops import rollout as tr

torch.set_num_threads(1)

B = 128

_SHIM = r"""
#include "rollout_math.cuh"
extern "C" int host_rollout(const void* cfg, const void* pk, const void* mt, const void* ma,
                            const void* rn, const void* sn, const void* sfi, const void* sii,
                            void* out, void* rst, void* sfo, void* sio) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  for (int b = 0; b < c.B; ++b)
    sgt::rollout_patient(c, (size_t)b, (const float*)pk, (const int32_t*)mt, (const float*)ma,
                         (const float*)rn, (const float*)sn, (const float*)sfi,
                         (const int32_t*)sii, (float*)out, (float*)rst, (float*)sfo,
                         (int32_t*)sio);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's math for the host")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", build.CSRC, str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    lib.host_rollout.argtypes = [ctypes.c_void_p] * 12
    return lib


def _host_rollout(lib, cfg, packed, key, reset_noise=None, step_noise=None):
    c = tr._c_config(cfg, B, tr._key(key), 1, 0)
    keep = []

    def ptr(t):
        if t is None:
            return None
        keep.append(t.contiguous())
        return keep[-1].data_ptr()

    mt = ma = None
    if cfg.det_meal_times:
        mt = torch.tensor(cfg.det_meal_times, dtype=torch.int32)
        ma = torch.tensor(cfg.det_meal_amounts, dtype=torch.float32)
    out = torch.empty(6, cfg.n_steps, B)
    rst = torch.zeros(2, B)
    sf = torch.empty(tr.NS_F, B)
    si = torch.empty(tr.NS_I, B, dtype=torch.int32)
    lib.host_rollout(ctypes.addressof(c), ptr(packed), ptr(mt), ptr(ma), ptr(reset_noise),
                     ptr(step_noise), None, None, ptr(out), ptr(rst), ptr(sf), ptr(si))
    return tr._result(dict(zip(("CGM", "BG", "reward", "done", "CHO", "insulin"), out.unbind(0))),
                      rst, sf, si)


_rng = np.random.default_rng(0)
_RN = torch.from_numpy(_rng.normal(0, 10, (2, B)).astype(np.float32))
_SN = torch.from_numpy(_rng.normal(0, 10, (24, B)).astype(np.float32))

CASES = {
    "det_pid": tr.RolloutConfig(n_steps=24, deterministic=True, controller="pid"),
    "det_bb_meals": tr.RolloutConfig(n_steps=24, deterministic=True, controller="bb",
                                     det_meal_times=(3, 10, 40), det_meal_amounts=(30.0, 25.0, 50.0)),
    "exo_bb": tr.RolloutConfig(n_steps=24, deterministic=True, exogenous_noise=True, autoreset=False,
                               controller="bb", det_meal_times=(3, 10), det_meal_amounts=(30.0, 25.0)),
    "static_native": tr.RolloutConfig(n_steps=24, scenario_kind="static", autoreset=False,
                                      fixed_start_min=0, controller="pid",
                                      det_meal_times=(3, 12), det_meal_amounts=(30.0, 25.0)),
    # start 23:00 so the midnight plan redraw runs; a low done threshold so
    # auto-resets run
    "stoch_pid_autoreset": tr.RolloutConfig(n_steps=40, controller="pid", fixed_start_min=1380,
                                            bg_done_high=180.0),
    "stoch_bb_navigator": tr.config_for_sensor("Navigator", n_steps=40, controller="bb"),
    "stoch_const_guardian": tr.config_for_sensor("GuardianRT", n_steps=24, controller="const",
                                                 const_basal=0.02, reward_kind="neg_risk"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_host_built_kernel_math_matches_plain_version(host_lib, name):
    cfg = CASES[name]
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names)
    packed = tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names))
    noise = dict(reset_noise=_RN, step_noise=_SN) if cfg.exogenous_noise else {}
    ref = tr.rollout_reference(cfg, packed, (7, 3), **noise)
    got = _host_rollout(host_lib, cfg, packed, (7, 3), **noise)
    for k in ("BG", "CGM", "BG0", "CGM0"):
        torch.testing.assert_close(got[k], ref[k], rtol=2e-6, atol=0, msg=k)
    torch.testing.assert_close(got["reward"], ref["reward"], rtol=0, atol=1e-4)
    for k in ("CHO", "insulin", "done", "state_i"):
        assert torch.equal(got[k], ref[k]), k
    sf_g, sf_r = got["state_f"].reshape(tr.NS_F, B), ref["state_f"].reshape(tr.NS_F, B)
    for i in range(tr.NS_F):
        floor = 2e-6 * sf_r[i].abs().max().item()
        torch.testing.assert_close(sf_g[i], sf_r[i], rtol=2e-6, atol=floor, msg=f"state plane {i}")
    if not cfg.deterministic:
        assert got["CGM"].ne(got["BG"]).any(), "noise must be on"
