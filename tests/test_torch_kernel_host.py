"""The CUDA kernel's per-patient math, built for the host, vs the plain
version.

csrc/rollout_math.cuh holds everything one CUDA thread computes as
__host__ __device__ functions.  Here it is compiled by g++ (no FMA
contraction) behind a small C loop over patients and the lanes of each
patient's group (each lane in turn, the MLP's exchange phase by phase; the
outputs start as NaN, so a row no lane stores fails) and run on the CPU
against :func:`rollout_reference`, through the same by-value config struct
the CUDA launcher takes.  The Philox draws are the same bits, so even the
stochastic configs agree lane for lane; only libm's and PyTorch's
transcendentals differ in their last bits.  Tolerances: BG/CGM rtol 2e-6,
reward atol 1e-4, CHO/insulin/done and the int state exact, the float
state rtol 2e-6 with an absolute floor of 2e-6 of each plane's largest
magnitude (cancellation in the PID integral and near-zero states).  Where
the card's own arithmetic (FMA, CUDA's libm) moves these, chip_smoke.py
states its tolerances.

The same goes for the roofline probe K6 (``csrc/roofline_math.cuh``: each
op's chain over one tile against ``ops/roofline.py::chain_reference``; fma,
mul, div and select exact, since without contraction both round each
operation alone, tanh/exp/log rtol 1e-5: libm and PyTorch may round an
application an ulp apart, and no op's map expands, so 64 steps stay within
64 ulp), the 'nn' controller of K1b (``rollout_patient_nn``, the
packed weights and a layer-1 buffer in place of shared memory), the GAE
walk of K2 (chunk by chunk through a shared-memory-like tile, as the
kernel stages it) and the grad-step block routine of K3 (``csrc/ppo_math.cuh``,
run as one thread per block over the same shared-memory layout; its
bfloat16 instantiation's tensor-core tile is emulated lane by lane, see
tests/test_torch_mma_tile.py), each against its plain version.  Tolerances there: K1b's insulin and insulin
planes within one pump increment per step, since its MLP sums in another
order than PyTorch's matmul and a command within an ulp of a rounding
boundary quantizes one increment apart (about one dose in 5000: lane 55 of
the sampled case at step 23); such a dose moves BG/CGM by up to 6.5e-6
relative within the horizon, so they are held to rtol 2e-5, the features
to atol 1e-4 and the value / raw action / log-prob to rtol 1e-4 with an
absolute floor of 1e-4 (4.7e-5 and 2.3e-6 measured); K2 exact (the same operations in the same order); K3 and K4 each gradient leaf
and loss sum within 2e-5 of its largest magnitude (row sums in another
order).  K5's grid runs as its barriers order it (per minibatch every
block's grad step, then every block's reduction, then every block's Adam
step) against the 'step' learner's loop, to the JAX package's tolerances
for its whole-learner kernel (tests/test_pallas_ppo_learner.py:195-212):
params and mu rtol 5e-3 / atol 3e-5, nu atol 1e-7, aux rtol 2e-3 / atol
1e-4."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.models.uva_padova import basal_rate
from simglucose_tpu_torch.ops import build
from simglucose_tpu_torch.ops import ppo_learner as lrn
from simglucose_tpu_torch.ops import roofline as rf
from simglucose_tpu_torch.ops import rollout as tr
from simglucose_tpu_torch.rl import policy as pol
from simglucose_tpu_torch.rl import ppo

torch.set_num_threads(1)

B = 128

_SHIM = r"""
#include <vector>

#include "ppo_math.cuh"
#include "roofline_math.cuh"
// Each patient's group of G lanes, one lane after another: every lane runs
// the patient's serial code and stores its own rows; the MLP's exchange
// runs every lane's phase in turn inside each call (sgt::nn_mlp).
extern "C" int host_rollout(const void* cfg, const void* pk, const void* mt, const void* ma,
                            const void* rn, const void* sn, const void* sfi, const void* sii,
                            void* out, void* rst, void* sfo, void* sio, int G) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  for (int b = 0; b < c.B; ++b)
    for (int g = 0; g < G; ++g)
      sgt::rollout_patient(c, (size_t)b, (const float*)pk, (const int32_t*)mt, (const float*)ma,
                           (const float*)rn, (const float*)sn, (const float*)sfi,
                           (const int32_t*)sii, (float*)out, (float*)rst, (float*)sfo,
                           (int32_t*)sio, sgt::Lanes{g, G, 0u});
  return 0;
}

extern "C" int host_rollout_nn(const void* cfg, const void* pk, const void* mt, const void* ma,
                               const void* w, void* out, void* lrn, void* obs, void* rst,
                               void* sfo, void* sio, int G) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  std::vector<float> h1(c.nn_hidden);
  const sgt::NNArgs nn{(const float*)w, c.nn_hidden + 16, h1.data(), (float*)lrn, (float*)obs};
  for (int b = 0; b < c.B; ++b)
    for (int g = 0; g < G; ++g)
      sgt::rollout_patient_nn(c, (size_t)b, (const float*)pk, (const int32_t*)mt,
                              (const float*)ma, nullptr, nullptr, nullptr, nullptr, (float*)out,
                              (float*)rst, (float*)sfo, (int32_t*)sio, nn, sgt::Lanes{g, G, 0u});
  return 0;
}

// K2 as the kernel walks it: each warp's 32 lanes, chunk by chunk from the
// last, each chunk's rows staged in a [row][lane] tile (lanes past B zero)
// and walked lane by lane with the carry kept across chunks.
extern "C" int host_gae(int T, int B, const void* r, const void* d, const void* v,
                        const void* tail, float gamma, float gl, void* out) {
  const float *rf = (const float*)r, *df = (const float*)d, *vf = (const float*)v;
  const int L = sgt::GAE_LANES, R = sgt::GAE_ROWS;
  std::vector<float> tr(R * L), td(R * L), tv(R * L);
  std::vector<sgt::GaeCarry> carry(L);
  float* o = (float*)out;
  const size_t TB = (size_t)T * B;
  for (int b0 = 0; b0 < B; b0 += L) {
    for (int l = 0; l < L && b0 + l < B; ++l) carry[l] = {0.0f, ((const float*)tail)[b0 + l]};
    for (int k = 0; k < sgt::gae_chunks(T); ++k) {
      int t0, n;
      sgt::gae_chunk(T, k, t0, n);
      for (int i = 0; i < n; ++i)
        for (int l = 0; l < L; ++l) {
          const bool in = b0 + l < B;
          const size_t src = (size_t)(t0 + i) * B + b0 + l;
          tr[i * L + l] = in ? rf[src] : 0.0f;
          td[i * L + l] = in ? df[src] : 0.0f;
          tv[i * L + l] = in ? vf[src] : 0.0f;
        }
      for (int l = 0; l < L && b0 + l < B; ++l) {
        float* adv = o + (size_t)t0 * B + b0 + l;
        sgt::gae_rows(n, &tr[l], &td[l], &tv[l], L, adv, adv + TB, (size_t)B, gamma, gl,
                      carry[l]);
      }
    }
  }
  return 0;
}

// the block routine at the compute dtype of a.bf16, as the launcher picks
// its instantiation
static void grad_blocks(const sgt::PPOArgs& a, int n_blk, float* out) {
  std::vector<float> smem(sgt::ppo_smem_bytes(a.H, a.bf16) / sizeof(float));
  const int n_cta = n_blk * a.split;
  for (int cta = 0; cta < n_cta; ++cta) {
    if (a.bf16)
      sgt::ppo_grad_block<false, true>(a, cta, smem.data(), 0, 1);
    else
      sgt::ppo_grad_block(a, cta, smem.data(), 0, 1);
  }
  const int L = sgt::ppo_out_len(a.H);
  for (int i = 0; i < L; ++i) out[i] = sgt::block_sum(a.partial, n_cta, L, i);
}

extern "C" int host_ppo_grad(const void* args, int n_blk, void* out) {
  grad_blocks(*static_cast<const sgt::PPOArgs*>(args), n_blk, (float*)out);
  return 0;
}

extern "C" int host_ppo_grad12(const void* args, int n_blk, void* out) {
  grad_blocks(sgt::ppo_grad12_args(*static_cast<const sgt::PPOArgs*>(args)), n_blk, (float*)out);
  return 0;
}

// K5's grid in the order its barriers impose: per minibatch, every block's
// work items of the grad step, then every block's reduction, then every
// block's Adam step
extern "C" int host_ppo_epoch(const void* args) {
  const sgt::EpochArgs e = *static_cast<const sgt::EpochArgs*>(args);
  std::vector<float> smem(sgt::ppo_smem_bytes(e.g.H, e.g.bf16) / sizeof(float));
  for (int k = 0; k < e.n_mb; ++k) {
    for (int b = 0; b < e.grid; ++b) {
      if (e.g.bf16)
        sgt::epoch_grad<true>(e, k, b, smem.data(), 0, 1);
      else
        sgt::epoch_grad(e, k, b, smem.data(), 0, 1);
    }
    for (int b = 0; b < e.grid; ++b) sgt::epoch_reduce(e, b, 0, 1);
    for (int b = 0; b < e.grid; ++b) sgt::epoch_adam(e, k, b, 0, 1);
  }
  return 0;
}

// The grad step's bfloat16 rounding, elementwise
extern "C" int host_bf16_round(const void* x, void* out, int n) {
  for (int i = 0; i < n; ++i) ((float*)out)[i] = sgt::bf16_round(((const float*)x)[i]);
  return 0;
}

// The bfloat16 tensor-core tile (ppo_math.cuh): each lane's fragment maps,
// [32][16] ints: (a_row, a_col) of a0..a7, (b_row, b_col) of b0..b3,
// (c_row, c_col) of c0..c3
extern "C" int host_mma_maps(void* out) {
  int* o = (int*)out;
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 8; ++i) { *o++ = sgt::mma_a_row(l, i); *o++ = sgt::mma_a_col(l, i); }
    for (int i = 0; i < 4; ++i) { *o++ = sgt::mma_b_row(l, i); *o++ = sgt::mma_b_col(l, i); }
    for (int i = 0; i < 4; ++i) { *o++ = sgt::mma_c_row(l, i); *o++ = sgt::mma_c_col(l, i); }
  }
  return 0;
}

// One warp's group of C = A B^T over depth K (a multiple of 16) as the
// grad step runs it: a 16 x 32 block (four 8-column tiles) from bfloat16
// operands (akc / bkc: each row of the operand runs along k, else each row
// of memory is one depth index; strides as and bs), through the emulated
// ldmatrix and mma; out [16, 32] by the C map
template <bool AKC, bool BKC>
static void mma_tile(const sgt::MmaB16& A, const sgt::MmaB16& B, int K, float* out) {
  float c[sgt::MMA_NT][sgt::MMA_LANES][4];
  sgt::mma_zero(c);
  sgt::mma_group<AKC, BKC>(c, A, B, 0, 0, K, 0);
  for (int j = 0; j < sgt::MMA_NT; ++j)
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i)
        out[sgt::mma_c_row(l, i) * 32 + 8 * j + sgt::mma_c_col(l, i)] = c[j][l][i];
}

extern "C" int host_mma_tile(int akc, const void* a, int as, int bkc, const void* b, int bs,
                             int K, void* out) {
  const sgt::MmaB16 A{(const uint16_t*)a, as}, B{(const uint16_t*)b, bs};
  float* o = (float*)out;
  if (akc && bkc) mma_tile<true, true>(A, B, K, o);
  else if (akc) mma_tile<true, false>(A, B, K, o);
  else if (bkc) mma_tile<false, true>(A, B, K, o);
  else mma_tile<false, false>(A, B, K, o);
  return 0;
}

// One emulated mma on raw fragments: a [32][4] and b [32][2] packed
// bfloat16 pairs, c [32][4] added to
extern "C" int host_mma_frags(const void* a, const void* b, void* c) {
  sgt::mma_bf16(*(float(*)[32][4])c, *(const uint32_t(*)[32][4])a, *(const uint32_t(*)[32][2])b);
  return 0;
}

// The host build's activation (act_f), elementwise
extern "C" int host_act(int act, const void* x, void* out, int n) {
  for (int i = 0; i < n; ++i) ((float*)out)[i] = sgt::act_f(act, ((const float*)x)[i]);
  return 0;
}

// K6's element routine over one tile, op and P chosen at run time
template <int P>
static int chain_tile(int op, const float* x, float* out, int K) {
  for (int i = 0; i < sgt::CHAIN_TILE; ++i) {
    switch (op) {
      case sgt::OP_FMA: out[i] = sgt::chain_sum<sgt::OP_FMA, P>(x[i], K); break;
      case sgt::OP_MUL: out[i] = sgt::chain_sum<sgt::OP_MUL, P>(x[i], K); break;
      case sgt::OP_TANH: out[i] = sgt::chain_sum<sgt::OP_TANH, P>(x[i], K); break;
      case sgt::OP_EXP: out[i] = sgt::chain_sum<sgt::OP_EXP, P>(x[i], K); break;
      case sgt::OP_LOG: out[i] = sgt::chain_sum<sgt::OP_LOG, P>(x[i], K); break;
      case sgt::OP_DIV: out[i] = sgt::chain_sum<sgt::OP_DIV, P>(x[i], K); break;
      case sgt::OP_SELECT: out[i] = sgt::chain_sum<sgt::OP_SELECT, P>(x[i], K); break;
      default: return 1;
    }
  }
  return 0;
}

extern "C" int host_chain(int op, int P, const void* x, void* out, int K) {
  const float* xf = (const float*)x;
  float* of = (float*)out;
  switch (P) {
    case 1: return chain_tile<1>(op, xf, of, K);
    case 4: return chain_tile<4>(op, xf, of, K);
    case 16: return chain_tile<16>(op, xf, of, K);
    default: return 1;
  }
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
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_rollout.argtypes = [vp] * 12 + [i32]
    lib.host_rollout_nn.argtypes = [vp] * 11 + [i32]
    lib.host_gae.argtypes = [i32, i32, vp, vp, vp, vp, f32, f32, vp]
    lib.host_ppo_grad.argtypes = [vp, i32, vp]
    lib.host_ppo_grad12.argtypes = [vp, i32, vp]
    lib.host_ppo_epoch.argtypes = [vp]
    lib.host_bf16_round.argtypes = [vp, vp, i32]
    lib.host_mma_maps.argtypes = [vp]
    lib.host_mma_tile.argtypes = [i32, vp, i32, i32, vp, i32, i32, vp]
    lib.host_mma_frags.argtypes = [vp, vp, vp]
    lib.host_act.argtypes = [i32, vp, vp, i32]
    lib.host_chain.argtypes = [i32, i32, vp, vp, i32]
    return lib


def _nan(*shape):
    """An output buffer whose every element a run must overwrite."""
    return torch.full(shape, float("nan"))


def _host_rollout(lib, cfg, packed, key, reset_noise=None, step_noise=None, G=1, lane_offset=0):
    c = tr._c_config(cfg, B, tr._key(key), 1, 0, lane_offset)
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
    out = _nan(6, cfg.n_steps, B)
    rst = _nan(2, B)
    sf = _nan(tr.NS_F, B)
    si = torch.full((tr.NS_I, B), -7, dtype=torch.int32)
    lib.host_rollout(ctypes.addressof(c), ptr(packed), ptr(mt), ptr(ma), ptr(reset_noise),
                     ptr(step_noise), None, None, ptr(out), ptr(rst), ptr(sf), ptr(si), G)
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


def _check_kernel_math(host_lib, name, G, lane_offset=0):
    cfg = CASES[name]
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    packed = tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))
    noise = dict(reset_noise=_RN, step_noise=_SN) if cfg.exogenous_noise else {}
    ref = tr.rollout_reference(cfg, packed, (7, 3), lane_offset=lane_offset, **noise)
    got = _host_rollout(host_lib, cfg, packed, (7, 3), G=G, lane_offset=lane_offset, **noise)
    if G > 1:  # the group's lanes store what one lane stores, bit for bit
        one = _host_rollout(host_lib, cfg, packed, (7, 3), G=1, **noise)
        for k in ("BG", "CGM", "reward", "done", "CHO", "insulin", "BG0", "CGM0", "state_f",
                  "state_i"):
            assert torch.equal(got[k], one[k]), k
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
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_host_built_kernel_math_matches_plain_version(host_lib, name):
    _check_kernel_math(host_lib, name, 1)


@pytest.mark.parametrize("name", ["stoch_pid_autoreset", "stoch_bb_navigator"])
def test_host_built_kernel_math_at_a_lane_offset(host_lib, name):
    """``RolloutCfg.lane0`` (a shard's first global lane, 384 here) keys
    every draw of the host build as ``rollout_reference(lane_offset=)``
    keys it, resets included; the draws move with it."""
    got = _check_kernel_math(host_lib, name, 1, lane_offset=384)
    assert not torch.equal(got["CGM"], _check_kernel_math(host_lib, name, 1)["CGM"])


@pytest.mark.parametrize("G", [2])
@pytest.mark.parametrize("name", ["stoch_pid_autoreset"])
def test_host_built_group_kernel_math_matches_plain_version(host_lib, name, G):
    """The shared rollout body run by a group of lanes (K1a itself runs
    one): every output row stored once (the buffers start as NaN), and the
    result the single lane's."""
    _check_kernel_math(host_lib, name, G)


# ---------------------------------------------------------------------------
# K1b: the 'nn' controller
# ---------------------------------------------------------------------------

H = 16
INC = 0.05 / 6000.0  # one Insulet basal increment, U/min
_MEALS = dict(det_meal_times=(3, 10, 40), det_meal_amounts=(30.0, 25.0, 50.0))


def _nn_cfg(sensor="Dexcom", hidden=H, **kw):
    return tr.config_for_sensor(sensor, controller="nn", nn_hidden=hidden, **kw)


NN_CASES = {
    # (config, decoder action_scale, mu bias)
    "det_emit_sigmoid_meals": (_nn_cfg(n_steps=24, deterministic=True, nn_emit_learner_rows=True,
                                       **_MEALS), 0.2, -1.0),
    "det_planes_residual_bb_meals": (_nn_cfg(n_steps=24, deterministic=True, nn_decoder="residual_bb",
                                             nn_action_scale=1.1, **_MEALS), 1.1, 0.3),
    "stoch_emit_sampled_autoreset": (_nn_cfg(n_steps=40, nn_emit_learner_rows=True, fixed_start_min=1380,
                                             bg_done_high=180.0), 0.2, -1.5),
    "stoch_planes_basal_scaled_eval_guardian": (
        _nn_cfg("GuardianRT", n_steps=24, nn_action_scale=10.0, nn_scale_by_basal=True,
                nn_sample_actions=False, autoreset=False), 10.0, -1.0),
    # the bench width and init_policy's default (layer 2 in blocks of four
    # units per lane)
    "det_emit_sigmoid_meals_h64": (_nn_cfg(hidden=64, n_steps=24, deterministic=True,
                                           nn_emit_learner_rows=True, **_MEALS), 0.2, -1.0),
    "stoch_planes_sampled_h128": (_nn_cfg(hidden=128, n_steps=24, fixed_start_min=1380,
                                          autoreset=False), 0.2, -1.5),
}


def _nn_weights(mu_bias, H=H):
    rng = np.random.default_rng(7)
    shapes = dict(w1=(7, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,), log_std=(1,),
                  w_v=(H, 1), b_v=(1,))
    arrs = [rng.normal(0, np.sqrt(2.0 / s[0]), s).astype(np.float32) for s in shapes.values()]
    arrs[5][:] = mu_bias
    arrs[6][:] = -0.5
    return tr.pack_policy_weights(pol.policy_from_numpy(arrs, act="relu", device="cpu"))


def _host_rollout_nn(lib, cfg, packed, key, w, G=1, lane_offset=0):
    c = tr._c_config(cfg, B, tr._key(key), 1, 0, lane_offset)
    T, emit = cfg.n_steps, cfg.nn_emit_learner_rows
    mt = ma = None
    if cfg.det_meal_times:
        mt = torch.tensor(cfg.det_meal_times, dtype=torch.int32)
        ma = torch.tensor(cfg.det_meal_amounts, dtype=torch.float32)
    out = _nan(6, T, B)
    planes = _nan(10 if emit else 6, T, B)
    rst = _nan(3 if emit else 7, B)
    sf = _nan(tr.NS_F, B)
    si = torch.full((tr.NS_I, B), -7, dtype=torch.int32)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib.host_rollout_nn(ctypes.addressof(c), ptr(packed), ptr(mt), ptr(ma), ptr(w), ptr(out),
                        ptr(planes) if emit else None, None if emit else ptr(planes), ptr(rst),
                        ptr(sf), ptr(si), G)
    traj = dict(zip(("CGM", "BG", "reward", "done", "CHO", "insulin"), out.unbind(0)))
    return tr._result(traj, rst, sf, si, planes, cfg)


@pytest.fixture(scope="module")
def packed():
    names = tables.cohort_names(B)
    p = tables.load_patient_params(names, device="cpu")
    return tr.pack_params(p, basal_rate(p), quest=tables.load_quest_params(names, device="cpu"))


def _check_nn_math(host_lib, packed, name, G, lane_offset=0):
    cfg, _, bias = NN_CASES[name]
    w = _nn_weights(bias, cfg.nn_hidden)
    ref = tr.rollout_reference(cfg, packed, (7, 3), weights=w, lane_offset=lane_offset)
    got = _host_rollout_nn(host_lib, cfg, packed, (7, 3), w, G, lane_offset)
    again = _host_rollout_nn(host_lib, cfg, packed, (7, 3), w, G, lane_offset)
    for k, v in got.items():  # every row stored (no NaN left), the same bits twice
        assert torch.equal(v, again[k]), k
    for k in ("BG", "CGM", "BG0", "CGM0"):
        torch.testing.assert_close(got[k], ref[k], rtol=2e-5, atol=0, msg=k)
    torch.testing.assert_close(got["reward"], ref["reward"], rtol=0, atol=1e-4)
    for k in ("CHO", "done", "state_i"):
        assert torch.equal(got[k], ref[k]), k
    torch.testing.assert_close(got["insulin"], ref["insulin"], rtol=0, atol=1.001 * INC)
    assert got["insulin"].max() > got["insulin"].min(), "the policy must act"
    nn_tol = dict(rtol=1e-4, atol=1e-4)
    dose_tol = dict(rtol=0, atol=1.001 * INC * cfg.sample_time * cfg.n_steps)
    if cfg.nn_emit_learner_rows:
        torch.testing.assert_close(got["learner"][0:7], ref["learner"][0:7], rtol=0, atol=1e-4)
        torch.testing.assert_close(got["learner"][7:10], ref["learner"][7:10], **nn_tol)
        torch.testing.assert_close(got["tail_value"], ref["tail_value"], **nn_tol)
    else:
        torch.testing.assert_close(got["raw"], ref["raw"], **nn_tol)
        for k in ("octrl", "oprev", "tail_octrl", "tail_oprev"):
            torch.testing.assert_close(got[k], ref[k], rtol=2e-6, atol=0, msg=k)
        for k in ("ocho", "tail_ocho"):
            assert torch.equal(got[k], ref[k]), k
        for k in ("oins", "oiob", "tail_oins", "tail_oiob"):
            torch.testing.assert_close(got[k], ref[k], msg=k, **dose_tol)
    if not cfg.deterministic:
        assert got["CGM"].ne(got["BG"]).any(), "noise must be on"
    if name.startswith("stoch_emit"):
        assert got["done"].any(), "the threshold must cause resets"
    return got


@pytest.mark.parametrize("name", list(NN_CASES))
def test_host_built_nn_math_matches_plain_version(host_lib, packed, name):
    _check_nn_math(host_lib, packed, name, 1)


@pytest.mark.parametrize("name", ["stoch_emit_sampled_autoreset", "stoch_planes_sampled_h128"])
def test_host_built_nn_math_at_a_lane_offset(host_lib, packed, name):
    """K1b at ``lane0`` = 4096 (the second rank of a 4096-lane batch, its
    group's lanes at the kernel's own G): the action noise, the reset and
    the CGM draws keyed as the plain version keys them."""
    got = _check_nn_math(host_lib, packed, name, tr.K1B_GROUP, lane_offset=4096)
    assert not torch.equal(got["raw" if "planes" in name else "learner"],
                           _check_nn_math(host_lib, packed, name, tr.K1B_GROUP)
                           ["raw" if "planes" in name else "learner"])


# K1b's group sizes besides one lane: 2, 4 and the kernel's own
NN_GROUPS = sorted({2, 4, tr.K1B_GROUP} - {1})


@pytest.mark.parametrize("G", NN_GROUPS)
@pytest.mark.parametrize("name", list(NN_CASES))
def test_host_built_group_nn_math_matches_plain_version(host_lib, packed, name, G):
    """K1b's body run by a group of G lanes, each owning every G-th unit of
    both layers, the heads' partials summed in the card's butterfly order;
    every output row stored once, the same bits on a second run."""
    _check_nn_math(host_lib, packed, name, G)


# ---------------------------------------------------------------------------
# K2 (GAE) and K3 (the grad step)
# ---------------------------------------------------------------------------


def _check_host_gae(host_lib, T, Bg):
    rng = np.random.default_rng(T)
    r, v = (torch.from_numpy(rng.normal(0, s, (T, Bg)).astype(np.float32)) for s in (1, 2))
    d = torch.from_numpy((rng.uniform(size=(T, Bg)) < 0.05).astype(np.float32))
    for t in (31, 32, 63, 64, T - 1):  # both sides of every chunk boundary
        if t < T:
            d[t, t % 7::7] = 1.0
    tail = torch.from_numpy(rng.normal(0, 2, Bg).astype(np.float32))
    gamma, lam = 0.99, 0.95
    out = _nan(2, T * Bg)
    host_lib.host_gae(T, Bg, r.data_ptr(), d.data_ptr(), v.data_ptr(), tail.data_ptr(), gamma,
                      gamma * lam, out.data_ptr())
    assert torch.equal(out, lrn.gae_pack_reference(r, d, v, tail, gamma=gamma, lam=lam))


def test_host_built_gae_matches_plain_version(host_lib):
    _check_host_gae(host_lib, 16, 256)


@pytest.mark.parametrize("T,Bg", [(1, 64), (64, 256), (77, 100)])
def test_host_built_gae_chunks_match_plain_version(host_lib, T, Bg):
    """K2's walk chunk by chunk (GAE_ROWS = 32 rows: T = 64 two full chunks,
    T = 77 ending on a 13-row chunk, B = 100 on a part-filled warp) equals
    the plain version bit for bit, with done flags on both sides of every
    chunk boundary."""
    _check_host_gae(host_lib, T, Bg)


def _host_grad_step(host_lib, act, bs, logp_shift, Hg, seed=1, split=1):
    rng = np.random.default_rng(seed)
    N = 1536
    main = np.zeros((10, N), np.float32)
    main[0:7] = rng.normal(0, 1, (7, N))
    main[7] = rng.normal(0, 3, N)
    main[8] = rng.normal(-1, 1, N)
    main[9] = rng.normal(-1.2, 0.3, N) + logp_shift
    advret = torch.from_numpy(rng.normal(0, 1, (2, N)).astype(np.float32))
    main = torch.from_numpy(main)
    w = [torch.from_numpy(rng.normal(0, 0.4 * (16 / Hg) ** 0.5, s).astype(np.float32))
         for s in ((7, Hg), (Hg,), (Hg, Hg), (Hg,), (Hg, 2), (2,))]
    perm_mb = torch.from_numpy(rng.permutation(N // bs)[:8])
    cols = (perm_mb[:, None] * bs + torch.arange(bs)).reshape(-1)
    adv = advret[0, cols]
    args = (main, advret, perm_mb, bs, *w, torch.tensor(-0.5), adv.mean(), adv.std(correction=0))
    kw = dict(act=act, clip_eps=0.2, vf_coef=0.5)
    a, _keep, out, n_blk = lrn._grad_step_args(*args, *kw.values(), split=split)
    host_lib.host_ppo_grad(ctypes.addressof(a), n_blk, out.data_ptr())
    got = lrn._grad_out(out, Hg)
    ref = lrn.ppo_grad_step_gather2_reference(*args, **kw)
    for f in lrn.PPOGradOut._fields:
        g, r = getattr(got, f), getattr(ref, f)
        assert float((g - r).abs().max()) <= 2e-5 * float(r.abs().max()), f


@pytest.mark.parametrize("act,bs,logp_shift", [("relu", 64, 0.0), ("tanh", 48, 0.0), ("relu", 48, -5.0)])
def test_host_built_grad_step_matches_plain_version(host_lib, act, bs, logp_shift):
    """One thread per block over the kernel's shared-memory layout, with
    shuffle blocks of 64 rows or 48 (both within one 128-row tile at H=16,
    a partial one); logp_shift=-5 puts most ratios past the clip."""
    _host_grad_step(host_lib, act, bs, logp_shift, 16)


@pytest.mark.parametrize("Hg,act,bs,logp_shift", [
    (20, "relu", 48, 0.0), (18, "tanh", 64, -5.0), (100, "relu", 48, 0.0),
    (128, "relu", 64, 0.0), (128, "tanh", 48, -5.0)])
def test_host_built_grad_step_widths_match_plain_version(host_lib, Hg, act, bs, logp_shift):
    """Other widths of the block routine: H=18 and 20 (columns past the
    last full micro-tile of a product: 18 is no multiple of 4, 20 leaves
    dW1's column pairs and the head partials uneven), H=100 and 128 (the
    32-row tiles: 64-row blocks are two tiles, 48-row blocks a full and a
    partial one)."""
    _host_grad_step(host_lib, act, bs, logp_shift, Hg, seed=Hg)


@pytest.mark.parametrize("Hg,bs,split", [(16, 64, 2), (20, 48, 4), (64, 48, 2), (128, 48, 2)])
def test_host_built_grad_step_split_matches_plain_version(host_lib, Hg, bs, split):
    """Each shuffle block over ``split`` CUDA blocks, each a contiguous
    part of its rows (H=64 at bs=48: two 24-row parts of a 64-row tile; H=20
    at split 4: four 12-row parts), their partials summed in block order."""
    _host_grad_step(host_lib, "tanh", bs, 0.0, Hg, seed=Hg + split, split=split)


def _rows12(rng, N, logp_shift=0.0):
    packed = np.zeros((12, N), np.float32)
    packed[0:7] = rng.normal(0, 1, (7, N))
    packed[8] = rng.normal(-1, 1, N)
    packed[9] = rng.normal(-1.2, 0.3, N) + logp_shift
    packed[10:12] = rng.normal(0, 1, (2, N))
    return torch.from_numpy(packed)


def _host_grad_step12(host_lib, act, logp_shift, Hg, seed=2, split=1):
    rng = np.random.default_rng(seed)
    N, bs = 1536, 48
    packed = _rows12(rng, N, logp_shift)
    w = [torch.from_numpy(rng.normal(0, 0.4 * (16 / Hg) ** 0.5, s).astype(np.float32))
         for s in ((7, Hg), (Hg,), (Hg, Hg), (Hg,), (Hg, 2), (2,))]
    perm_mb = torch.from_numpy(rng.permutation(N // bs)[:8])
    cols = (perm_mb[:, None] * bs + torch.arange(bs)).reshape(-1)
    adv = packed[10, cols]
    args = (packed, perm_mb, bs, *w, torch.tensor(-0.5), adv.mean(), adv.std(correction=0))
    kw = dict(act=act, clip_eps=0.2, vf_coef=0.5)
    a, _keep, out, n_blk = lrn._grad_step_args(*args[:1], None, *args[1:], *kw.values(),
                                               n=2 * len(cols), split=split)
    host_lib.host_ppo_grad12(ctypes.addressof(a), n_blk, out.data_ptr())
    got = lrn._grad_out(out, Hg)
    ref = lrn.ppo_grad_step_gather_reference(*args, loss_rows=2 * len(cols), **kw)
    for f in lrn.PPOGradOut._fields:
        g, r = getattr(got, f), getattr(ref, f)
        assert float((g - r).abs().max()) <= 2e-5 * float(r.abs().max()), f


@pytest.mark.parametrize("act,logp_shift", [("relu", 0.0), ("tanh", -5.0)])
def test_host_built_grad_step_12_rows_matches_plain_version(host_lib, act, logp_shift):
    """K4: the block routine over the 12-row buffer (48-row shuffle blocks,
    a partial tile), the losses scaled by a loss_rows of twice the
    minibatch."""
    _host_grad_step12(host_lib, act, logp_shift, 16)


@pytest.mark.parametrize("Hg,act", [(20, "tanh"), (128, "relu")])
def test_host_built_grad_step_12_rows_widths_match_plain_version(host_lib, Hg, act):
    """K4 at H=20 and at H=128 (32-row tiles: a 48-row block is a full
    tile and a partial one)."""
    _host_grad_step12(host_lib, act, 0.0, Hg, seed=Hg)


def test_host_built_grad_step_12_rows_split_matches_plain_version(host_lib):
    """K4 with each 48-row shuffle block over two CUDA blocks."""
    _host_grad_step12(host_lib, "relu", -5.0, 16, seed=5, split=2)


def _host_whole_learner(host_lib, act, max_grad_norm, Hg, seed=4, split=1, grid=None):
    """K5 on the host and its plain version: (the kernel's tensors, the
    plain params, Adam state and aux, the params it started from)."""
    rng = np.random.default_rng(seed)
    N, bs = 2048, 64
    packed = _rows12(rng, N)
    cfg = ppo.PPOConfig(epochs=2, minibatches=2, lr=1e-3, max_grad_norm=max_grad_norm)
    opt = ppo.make_optimizer(cfg)
    shapes = ((7, Hg), (Hg,), (Hg, Hg), (Hg,), (Hg, 1), (1,), (1,), (Hg, 1), (1,))
    arrs = [rng.normal(0, 0.4 * (16 / Hg) ** 0.5, s).astype(np.float32) for s in shapes]
    arrs[6][:] = -0.5
    params = pol.policy_from_numpy(arrs, act=act, device="cpu")
    P = ppo.flatten_params(params).numel()
    state = ppo.AdamState(3, torch.from_numpy(rng.normal(0, 1e-2, P).astype(np.float32)),
                          torch.from_numpy(rng.uniform(0, 1e-4, P).astype(np.float32)))
    n_blocks, bpm = N // bs, 8
    perm_all = torch.cat([torch.from_numpy(rng.permutation(n_blocks)[:2 * bpm])
                          for _ in range(2)])
    adv_b = packed[10].view(n_blocks, bs)
    mean, std = ppo.minibatch_adv_stats(adv_b.sum(1), (adv_b * adv_b).sum(1),
                                        perm_all.view(-1, bpm), bpm * bs)
    e, keep = lrn._epoch_args(cfg, opt, params, state, packed, perm_all, bs, mean, std, bpm * bs,
                              split=split, grid=grid)
    host_lib.host_ppo_epoch(ctypes.addressof(e))
    ref = lrn.ppo_epoch_update_reference(cfg, opt, params, state, packed, perm_all, bs, mean, std)
    return keep, ref, params


def _check_whole_learner(keep, ref, params, max_grad_norm):
    ref_p, ref_s, ref_aux = ref
    ref_flat = ppo.flatten_params(ref_p)
    tol = dict(rtol=5e-3, atol=3e-5)
    torch.testing.assert_close(keep["params"], ref_flat, **tol)
    assert float((ref_flat - ppo.flatten_params(params)).abs().max()) > 1e-3
    torch.testing.assert_close(keep["mu"], ref_s.mu, **tol)
    torch.testing.assert_close(keep["nu"], ref_s.nu, rtol=5e-3, atol=1e-7)
    torch.testing.assert_close(keep["aux"], ref_aux, rtol=2e-3, atol=1e-4)
    assert ref_s.count == 3 + 4
    clipped = bool((ref_aux[:, 3] >= max_grad_norm).all())
    assert clipped == (max_grad_norm < 1.0), ref_aux[:, 3]


@pytest.mark.parametrize("act,max_grad_norm", [("relu", 0.5), ("tanh", 100.0)])
def test_host_built_whole_learner_matches_plain_version(host_lib, act, max_grad_norm):
    """K5 over 2 epochs x 2 minibatches of eight 64-row blocks, from an
    Adam state three steps in, with the global-norm clip active (0.5) or
    not (100): params, Adam's mu and nu, and the aux rows (pg loss, value
    loss, entropy, gradient norm)."""
    _check_whole_learner(*_host_whole_learner(host_lib, act, max_grad_norm, 16), max_grad_norm)


@pytest.mark.parametrize("Hg,act,max_grad_norm", [(20, "relu", 100.0), (128, "tanh", 0.5)])
def test_host_built_whole_learner_widths_match_plain_version(host_lib, Hg, act, max_grad_norm):
    """K5 at H=20 and at H=128 (two 32-row tiles per block)."""
    _check_whole_learner(*_host_whole_learner(host_lib, act, max_grad_norm, Hg, seed=Hg),
                         max_grad_norm)


@pytest.mark.parametrize("Hg,split", [(16, 2), (128, 2)])
def test_host_built_whole_learner_split_matches_plain_version(host_lib, Hg, split):
    """K5 with each shuffle block over two CUDA blocks (16 per minibatch):
    the reduction and the Adam slices run over all of them."""
    _check_whole_learner(*_host_whole_learner(host_lib, "tanh", 0.5, Hg, seed=Hg + 1,
                                              split=split), 0.5)


@pytest.mark.parametrize("Hg,split,grid", [(16, 1, 3), (20, 2, 5), (128, 1, 1)])
def test_host_built_whole_learner_grid_stride_matches_plain_version(host_lib, Hg, split, grid):
    """K5 launched with fewer CUDA blocks than work items (8 or 16 per
    minibatch), as on a card that cannot hold one block per item: each
    block walks items b, b + grid, ... and the reduction and the Adam
    slices run over the grid's blocks."""
    _check_whole_learner(*_host_whole_learner(host_lib, "relu", 0.5, Hg, seed=Hg + grid,
                                              split=split, grid=grid), 0.5)


@pytest.mark.parametrize("Hg,split", [(16, 1), (128, 1), (64, 2)])
def test_host_built_whole_learner_is_bit_identical(host_lib, Hg, split):
    """Two host runs of K5 on the same inputs give the same bits.  The host
    runs one thread, so this guards only that every fold runs in an order
    fixed by the inputs and the grid; the card's run-to-run identity, where
    threads race, is checked by ``chip_smoke.py``."""
    a, _, _ = _host_whole_learner(host_lib, "relu", 0.5, Hg, split=split)
    b, _, _ = _host_whole_learner(host_lib, "relu", 0.5, Hg, split=split)
    for k in ("params", "mu", "nu", "aux"):
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# K6 (the roofline probe)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", rf.OPS)
def test_host_built_chain_matches_plain_version(host_lib, op):
    x = torch.from_numpy(np.random.default_rng(8).uniform(0.05, 1.2, rf.TILE).astype(np.float32))
    K = 64
    out = torch.empty(rf.TILE)
    for P in rf.KERNEL_P:
        assert host_lib.host_chain(rf.OPS.index(op), P, x.data_ptr(), out.data_ptr(), K) == 0
        ref = rf.chain_reference(op, x, K, P)
        if op in ("fma", "mul", "div", "select"):
            assert torch.equal(out, ref), P
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=0, msg=f"P={P}")
    assert host_lib.host_chain(rf.OPS.index(op), 2, x.data_ptr(), out.data_ptr(), K) == 1
