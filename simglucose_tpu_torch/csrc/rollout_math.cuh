// Per-patient math of the closed-loop rollout K1a, shared by the CUDA
// kernel (rollout.cu) and any host build of this header.
//
// Every function is __host__ __device__ and follows the plain PyTorch
// version in simglucose_tpu_torch/ops/rollout.py operation for operation
// (same expression order, same float32 constants), which in turn follows
// the JAX kernel simglucose_tpu/ops/pallas_rollout.py::_make_kernel.
// Randomness is Philox-4x32-10 with key (scenario seed, cgm seed) and
// counter (patient, global step, draw site, 0): the plain version draws the
// same bits (ops/philox.py).
//
// Rounding: pump quantization and meal times round half to even (rintf), as
// jnp.round and torch.round do.  max/min/clip are written so that a NaN
// operand propagates, as jnp.maximum/jnp.clip and torch.clamp do: the Quest
// sentinel (CR/CF <= 0 -> NaN) must poison a basal-bolus dose.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define SGT_HD __host__ __device__ __forceinline__
#define SGT_UNROLL _Pragma("unroll")
#else
#define SGT_HD inline
#define SGT_UNROLL
#endif

namespace sgt {

// Config scalars, passed to the kernel by value.  Mirrored field for field
// by _CConfig in ops/rollout.py: every field is 4 bytes, keep the order.
struct RolloutCfg {
  int32_t B, T, step_offset, init;
  uint32_t key0, key1;
  int32_t sample_time, controller, deterministic, exogenous_noise,
      scenario_static, autoreset, random_init_bg, reward_neg_risk,
      fixed_start_min, n_meals;
  float pacf, gamma, lam, delta, xi, cgm_min, cgm_max;
  float inc_basal, min_basal, max_basal, inc_bolus, min_bolus, max_bolus;
  float pid_p, pid_i, pid_d, pid_target, bb_target, const_basal;
  float bg_done_low, bg_done_high;
  float meal_cdf_lo[6], meal_cdf_span[6];
  int32_t meal_full_ndtri[6];
  // the 'nn' controller (K1b); unused by pid/bb/const
  int32_t nn_hidden, nn_scale_by_basal, nn_sample_actions, nn_residual_bb, nn_emit;
  float nn_action_scale, iob_decay;
  // global lane of this call's patient 0: the Philox streams are keyed by
  // lane0 + b, so a shard of the batch draws what the whole batch would
  int32_t lane0;
};

enum Controller { CTRL_PID = 0, CTRL_BB = 1, CTRL_CONST = 2, CTRL_NN = 3 };

// Philox draw sites (counter word 2), as in ops/rollout.py
enum Site : uint32_t {
  SITE_CGM = 0,
  SITE_MEAL = 1,        // 1..5
  SITE_RESET = 6,       // 6..7
  SITE_INIT_MEAL = 8,   // 8..12
  SITE_INIT_RESET = 13, // 13..14
  SITE_ACTION = 15      // the 'nn' controller's Gaussian action noise
};

constexpr int NP_PLANES = 50;
constexpr int N_FIELDS = 34;  // packed planes 0..33, then x0 34..46, basal 47, CR 48, CF 49
constexpr int NS_F = 64;
constexpr int NS_I = 7;
constexpr int MDL_SAMPLE_TIME = 15;
constexpr int MINUTES_PER_DAY = 1440;
constexpr float EAT_RATE = 5.0f;

// Launch shapes of the rollout kernels (rollout.cu), mirrored in
// ops/rollout.py: threads per block and the group of lanes that runs one
// patient.  K1a runs one patient per thread; K1b spreads each patient over
// K1B_GROUP lanes of a warp, which split the MLP between them.
constexpr int K1A_THREADS = 32;
constexpr int K1A_GROUP = 1;
constexpr int K1B_THREADS = 128;
constexpr int K1B_GROUP = 4;

// ---------------------------------------------------------------------------
// The lanes of one patient's group
// ---------------------------------------------------------------------------

// Lane g of the G lanes (G a power of two, at most 8, aligned within a warp)
// that run one patient.  Every lane runs the patient's serial code on the
// same inputs and draws, so every lane holds the same bits; work split
// between them is exchanged inside nn_mlp, and each output row is stored
// by one lane only (owns).  mask: the group's lanes within the warp (the
// card); the host build runs the lanes one after another.
struct Lanes {
  int g, G;
  unsigned mask;
  SGT_HD bool owns(int row) const { return row % G == g; }
};

SGT_HD Lanes lanes_of(int thread, int G) {
  const int first = (thread & 31) & ~(G - 1);
  return Lanes{thread & (G - 1), G, ((1u << G) - 1u) << first};
}

// ---------------------------------------------------------------------------
// NaN-propagating comparisons and clips (the constant is never NaN)
// ---------------------------------------------------------------------------

SGT_HD float max_c(float x, float c) { return x < c ? c : x; }
SGT_HD float min_c(float x, float c) { return x > c ? c : x; }
SGT_HD float clip(float x, float lo, float hi) { return min_c(max_c(x, lo), hi); }

// ---------------------------------------------------------------------------
// Philox-4x32-10
// ---------------------------------------------------------------------------

SGT_HD uint32_t mulhi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * (uint64_t)b) >> 32);
#endif
}

SGT_HD void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                          uint32_t k0, uint32_t k1, uint32_t out[4]) {
SGT_UNROLL
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = mulhi32(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = mulhi32(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// n_quads Philox blocks at consecutive sites -> 4 * n_quads words
SGT_HD void draw_words(const RolloutCfg& c, uint32_t lane, uint32_t step,
                       uint32_t site, int n_quads, uint32_t* w) {
  for (int q = 0; q < n_quads; ++q)
    philox4x32_10(lane, step, site + (uint32_t)q, 0u, c.key0, c.key1, w + 4 * q);
}

// top 24 bits * 2^-24 (exact in float), clamped so log(u) stays finite
SGT_HD float uniform01(uint32_t bits) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;
  return u < 1e-7f ? 1e-7f : u;
}

SGT_HD void box_muller(uint32_t w1, uint32_t w2, float& z1, float& z2) {
  const float r = sqrtf(-2.0f * logf(uniform01(w1)));
  const float th = 6.2831855f * uniform01(w2);
  z1 = r * cosf(th);
  z2 = r * sinf(th);
}

// ---------------------------------------------------------------------------
// Inverse normal CDF (Acklam), sensor noise, pump, risk
// ---------------------------------------------------------------------------

SGT_HD float ndtri_central(float p) {
  const float q = p - 0.5f;
  const float r = q * q;
  const float num = ((((-3.969683028665376e01f * r + 2.209460984245205e02f) * r +
                       -2.759285104469687e02f) * r + 1.383577518672690e02f) * r +
                     -3.066479806614716e01f) * r + 2.506628277459239e00f;
  const float den = (((((-5.447609879822406e01f * r + 1.615858368580409e02f) * r +
                        -1.556989798598866e02f) * r + 6.680131188771972e01f) * r +
                      -1.328068155288572e01f) * r) + 1.0f;
  return num * q / den;
}

SGT_HD float ndtri_tail_ratio(float q) {
  const float num = ((((-7.784894002430293e-03f * q + -3.223964580411365e-01f) * q +
                       -2.400758277161838e00f) * q + -2.549732539343734e00f) * q +
                     4.374664141464968e00f) * q + 2.938163982698783e00f;
  const float den = (((7.784695709041462e-03f * q + 3.224671290700398e-01f) * q +
                      2.445134137142996e00f) * q + 3.754408661907416e00f) * q + 1.0f;
  return num / den;
}

SGT_HD float ndtri(float p) {
  p = clip(p, 1e-7f, 0.9999999f);
  if (p < 0.02425f) return ndtri_tail_ratio(sqrtf(-2.0f * logf(p)));
  if (p > 0.97575f) return -ndtri_tail_ratio(sqrtf(-2.0f * logf(1.0f - p)));
  return ndtri_central(p);
}

SGT_HD float johnson(const RolloutCfg& c, float x) {
  const float z = (x - c.gamma) / c.delta;
  const float ez = expf(z);
  return c.xi + (c.lam * 0.5f) * (ez - 1.0f / ez);
}

SGT_HD float catmull(float l0, float l1, float l2, float l3, float u) {
  const float m1 = 0.5f * (l2 - l0);
  const float m2 = 0.5f * (l3 - l1);
  const float u2 = u * u;
  const float u3 = u2 * u;
  return (2.0f * u3 - 3.0f * u2 + 1.0f) * l1 + (u3 - 2.0f * u2 + u) * m1 +
         (-2.0f * u3 + 3.0f * u2) * l2 + (u3 - u2) * m2;
}

SGT_HD float quantize(float amount, float inc, float lo, float hi) {
  return clip(rintf(amount * 6000.0f / inc) * inc / 6000.0f, lo, hi);
}

SGT_HD float risk_of(float bg) {
  const float logbg = logf(max_c(bg, 1.0f));
  const float f = 1.509f * (powf(logbg, 1.084f) - 5.381f);
  return 10.0f * f * f;
}

// ---------------------------------------------------------------------------
// UVA/Padova right-hand side and the RK4 minute
// ---------------------------------------------------------------------------

struct Patient {
  float BW, EGPb, Gb, Ib, kabs, kmax, kmin, b, d, Vg, Vi, Vmx, Km0, k2, k1,
      p2u, m1, m2, m4, m30, ki, kp1, kp2, kp3, f, ke1, ke2, Fsnc, Vm0, kd, ksc,
      ka1, ka2, u2ss;
  // the gastric constants 2.5 / (1 - b) and 2.5 / d, the first divisions
  // of model_rhs's aa and cc, computed once
  float gut_b, gut_d;
};

// the PatientParams planes 0..33 of the packed [50, B] parameters
SGT_HD Patient load_patient(const float* pk, size_t B, size_t b) {
  Patient p;
  size_t i = 0;
#define SGT_LD(name) p.name = pk[(i++) * B + b]
  SGT_LD(BW); SGT_LD(EGPb); SGT_LD(Gb); SGT_LD(Ib); SGT_LD(kabs); SGT_LD(kmax);
  SGT_LD(kmin); SGT_LD(b); SGT_LD(d); SGT_LD(Vg); SGT_LD(Vi); SGT_LD(Vmx);
  SGT_LD(Km0); SGT_LD(k2); SGT_LD(k1); SGT_LD(p2u); SGT_LD(m1); SGT_LD(m2);
  SGT_LD(m4); SGT_LD(m30); SGT_LD(ki); SGT_LD(kp1); SGT_LD(kp2); SGT_LD(kp3);
  SGT_LD(f); SGT_LD(ke1); SGT_LD(ke2); SGT_LD(Fsnc); SGT_LD(Vm0); SGT_LD(kd);
  SGT_LD(ksc); SGT_LD(ka1); SGT_LD(ka2); SGT_LD(u2ss);
#undef SGT_LD
  p.gut_b = 2.5f / (1.0f - p.b);
  p.gut_d = 2.5f / p.d;
  return p;
}

// The right-hand side at x.  aa, cc: the gastric slopes of the minute's
// Dbar, 2.5 / (1 - b) / Dbar and 2.5 / d / Dbar (rk4_minute computes them
// once for its four evaluations: the same divisions of the same operands).
SGT_HD void model_rhs(const Patient& p, const float* x, float d_mg, float ins_rate,
                      float Dbar, float aa, float cc, float* dx) {
  const float qsto = x[0] + x[1];
  // gastric emptying: tanh-interpolated while a meal is in transit
  float kgut = p.kmax;
  if (Dbar > 0.0f) {
    kgut = p.kmin + (p.kmax - p.kmin) / 2.0f *
                        (tanhf(aa * (qsto - p.b * Dbar)) - tanhf(cc * (qsto - p.d * Dbar)) + 2.0f);
  }
  dx[0] = -p.kmax * x[0] + d_mg;
  dx[1] = p.kmax * x[0] - x[1] * kgut;
  dx[2] = kgut * x[1] - p.kabs * x[2];

  const float Rat = p.f * p.kabs * x[2] / p.BW;
  const float EGPt = p.kp1 - p.kp2 * x[3] - p.kp3 * x[8];
  const float Uiit = p.Fsnc;
  const float Et = x[3] > p.ke2 ? p.ke1 * (x[3] - p.ke2) : 0.0f;
  const float d3 = max_c(EGPt, 0.0f) + Rat - Uiit - Et - p.k1 * x[3] + p.k2 * x[4];
  dx[3] = x[3] >= 0.0f ? d3 : 0.0f;

  const float Vmt = p.Vm0 + p.Vmx * x[6];
  const float Uidt = Vmt * x[4] / (p.Km0 + x[4]);
  const float d4 = -Uidt + p.k1 * x[3] - p.k2 * x[4];
  dx[4] = x[4] >= 0.0f ? d4 : 0.0f;

  const float d5 = -(p.m2 + p.m4) * x[5] + p.m1 * x[9] + p.ka1 * x[10] + p.ka2 * x[11];
  const float It = x[5] / p.Vi;
  dx[5] = x[5] >= 0.0f ? d5 : 0.0f;

  dx[6] = -p.p2u * x[6] + p.p2u * (It - p.Ib);
  dx[7] = -p.ki * (x[7] - It);
  dx[8] = -p.ki * (x[8] - x[7]);

  const float d9 = -(p.m1 + p.m30) * x[9] + p.m2 * x[5];
  dx[9] = x[9] >= 0.0f ? d9 : 0.0f;

  const float d10 = ins_rate - (p.ka1 + p.kd) * x[10];
  dx[10] = x[10] >= 0.0f ? d10 : 0.0f;
  const float d11 = p.kd * x[10] - p.ka2 * x[11];
  dx[11] = x[11] >= 0.0f ? d11 : 0.0f;

  const float d12 = -p.ksc * x[12] + p.ksc * x[3];
  dx[12] = x[12] >= 0.0f ? d12 : 0.0f;
}

// Classic RK4 over one minute.  The stage sum a + 2b + 2c + d is accumulated
// in that order, so only four 13-vectors are live at once.
SGT_HD void rk4_minute(const Patient& p, float* x, float d_mg, float ins_rate, float Dbar) {
  float k[13], y[13], s[13];
  const float aa = Dbar > 0.0f ? p.gut_b / Dbar : 0.0f;
  const float cc = Dbar > 0.0f ? p.gut_d / Dbar : 0.0f;
  model_rhs(p, x, d_mg, ins_rate, Dbar, aa, cc, k);
SGT_UNROLL
  for (int i = 0; i < 13; ++i) {
    s[i] = k[i];
    y[i] = x[i] + 0.5f * k[i];
  }
  model_rhs(p, y, d_mg, ins_rate, Dbar, aa, cc, k);
SGT_UNROLL
  for (int i = 0; i < 13; ++i) {
    s[i] = s[i] + 2.0f * k[i];
    y[i] = x[i] + 0.5f * k[i];
  }
  model_rhs(p, y, d_mg, ins_rate, Dbar, aa, cc, k);
SGT_UNROLL
  for (int i = 0; i < 13; ++i) {
    s[i] = s[i] + 2.0f * k[i];
    y[i] = x[i] + k[i];
  }
  model_rhs(p, y, d_mg, ins_rate, Dbar, aa, cc, k);
SGT_UNROLL
  for (int i = 0; i < 13; ++i) x[i] = x[i] + (1.0f / 6.0f) * (s[i] + k[i]);
}

// ---------------------------------------------------------------------------
// Scenario and episode draws
// ---------------------------------------------------------------------------

// One day's meal plan from 18 words (5 Philox blocks at `site`): a skipped
// slot has time -1 and amount 0.
SGT_HD void draw_meal_plan(const RolloutCfg& c, uint32_t lane, uint32_t step,
                           uint32_t site, float* mt, float* ma) {
  const float prob[6] = {0.95f, 0.3f, 0.95f, 0.3f, 0.95f, 0.3f};
  const float t_mu[6] = {420.0f, 570.0f, 720.0f, 900.0f, 1080.0f, 1290.0f};
  const float t_sig[6] = {60.0f, 30.0f, 60.0f, 30.0f, 60.0f, 30.0f};
  const float a_mu[6] = {45.0f, 10.0f, 70.0f, 10.0f, 80.0f, 10.0f};
  const float a_sig[6] = {10.0f, 5.0f, 10.0f, 5.0f, 10.0f, 5.0f};
  uint32_t w[20];
  draw_words(c, lane, step, site, 5, w);
  float az[6];
SGT_UNROLL
  for (int i = 0; i < 3; ++i) box_muller(w[2 * i], w[2 * i + 1], az[2 * i], az[2 * i + 1]);
SGT_UNROLL
  for (int s = 0; s < 6; ++s) {
    const float u_occ = uniform01(w[6 + 2 * s]);
    const float u_t = uniform01(w[7 + 2 * s]);
    const float pin = c.meal_cdf_lo[s] + u_t * c.meal_cdf_span[s];
    const float z = c.meal_full_ndtri[s] ? ndtri(pin) : ndtri_central(pin);
    const float t = rintf(t_mu[s] + t_sig[s] * z);
    const float amt = max_c(rintf(a_mu[s] + a_sig[s] * az[s]), 0.0f);
    const bool occurs = u_occ < prob[s];
    mt[s] = occurs ? t : -1.0f;
    ma[s] = occurs ? amt : 0.0f;
  }
}

// Fresh-episode values: ODE state (x0 with random init BG), AR(1) state,
// noise lattice, start minute and the reset CGM sample.  b indexes the
// patient's planes of this call; lane, its global lane, keys the draws.
struct Episode {
  float x[13];
  float e, lat[4], cgm0;
  int32_t start;
};

SGT_HD void draw_episode(const RolloutCfg& c, const float* pk, size_t B, size_t b,
                         uint32_t lane, float Vg, uint32_t step, uint32_t site, Episode& ep) {
SGT_UNROLL
  for (int i = 0; i < 13; ++i) ep.x[i] = pk[(N_FIELDS + i) * B + b];
  ep.e = 0.0f;
  ep.lat[0] = ep.lat[1] = ep.lat[2] = ep.lat[3] = 0.0f;
  ep.start = 0;
  if (!c.deterministic) {
    uint32_t w[8];
    draw_words(c, lane, step, site, 2, w);
    float z[6];
    box_muller(w[0], w[1], z[0], z[1]);
    box_muller(w[2], w[3], z[2], z[3]);
    box_muller(w[4], w[5], z[4], z[5]);
    const bool lattice = !c.exogenous_noise;
    int lat_from = -1;
    if (c.random_init_bg) {
      const int idx[3] = {3, 4, 12};
SGT_UNROLL
      for (int j = 0; j < 3; ++j) {
        const float mean = ep.x[idx[j]];
        ep.x[idx[j]] = mean + sqrtf(0.1f * mean) * z[j];
      }
      if (lattice) lat_from = 3;
    } else if (lattice) {
      lat_from = 0;
    }
    if (lat_from >= 0) {
      const float e0 = z[lat_from];
      const float e1 = c.pacf * (e0 + z[lat_from + 1]);
      const float e2 = c.pacf * (e1 + z[lat_from + 2]);
      const float j0 = johnson(c, e0);
      ep.e = e2;
      ep.lat[0] = j0;
      ep.lat[1] = j0;
      ep.lat[2] = johnson(c, e1);
      ep.lat[3] = johnson(c, e2);
    }
    ep.start = c.fixed_start_min >= 0 ? c.fixed_start_min
                                      : (int32_t)floorf(uniform01(w[6]) * 24.0f) * 60;
  }
  ep.cgm0 = clip(ep.x[12] / Vg + ep.lat[1], c.cgm_min, c.cgm_max);
}

// ---------------------------------------------------------------------------
// The 'nn' controller (K1b): features, the relu MLP, action and decoder
// ---------------------------------------------------------------------------

constexpr float LOG_2PI = 1.8378770664093453f;

// What one patient's 'nn' controller reads and writes besides the K1a
// planes.  w: the packed weights of ops/rollout.py pack_policy_weights,
// rows of H+16 floats stored ldw apart (shared memory on the card, padded
// to H+20 there; 16-byte aligned); h1: this patient's H layer-1
// activations (16-byte aligned); lrn: the learner rows [10, T, B] (emit
// mode) or obs: the observation planes [6, T, B] (raw, octrl, oins, ocho,
// oprev, oiob); the other one is null.
struct NNArgs {
  const float* w;
  int ldw;
  float* h1;
  float* lrn;
  float* obs;
};

// Per-patient constants of the features (rl/policy.py featurize_parts),
// hoisted out of the step loop as in the JAX kernel.
struct NNLane {
  float inv3b, inv120b, f7;
};

SGT_HD NNLane nn_lane(float basal) {
  NNLane l;
  l.inv3b = 1.0f / (3.0f * (basal + 1e-8f));
  l.inv120b = 1.0f / (120.0f * (basal + 1e-8f));
  l.f7 = tanhf(20.0f * basal);
  return l;
}

SGT_HD void nn_features(const NNLane& l, float ctrl_prev, float ins_prev, float prev_cho,
                        float ctrl_pprev, float iob, float* f) {
  f[0] = ctrl_prev * 0.0025f;
  f[1] = (ctrl_prev - 140.0f) * 0.01f;
  f[2] = tanhf(ins_prev * l.inv3b);
  f[3] = tanhf(prev_cho * 0.1f);
  f[4] = tanhf((ctrl_prev - ctrl_pprev) * 0.1f);
  f[5] = tanhf(iob * l.inv120b);
  f[6] = l.f7;
}

// The relu trunk 7 -> H -> H and the (mu, value) heads from the packed
// weights, split over a patient's G lanes: lane g owns the units j = g,
// g + G, g + 2G, ... of both layers.  Each unit sums its inputs in order
// k = 0..H-1, as one thread did; only the heads' sums change order (each
// lane folds its own units in order, then the group adds the G partials).

SGT_HD void load4(const float* p, float* q) {
#if defined(__CUDA_ARCH__)
  const float4 t = *reinterpret_cast<const float4*>(p);
  q[0] = t.x;
  q[1] = t.y;
  q[2] = t.z;
  q[3] = t.w;
#else
  q[0] = p[0];
  q[1] = p[1];
  q[2] = p[2];
  q[3] = p[3];
#endif
}

// Lane g's layer-1 units into the patient's h1.
SGT_HD void nn_layer1(const NNArgs& nn, int H, const float* f, int g, int G) {
  for (int j = g; j < H; j += G) {
    const float* row = nn.w + j * nn.ldw;
    float a = 0.0f;
SGT_UNROLL
    for (int k = 0; k < 7; ++k) a = a + row[k] * f[k];
    nn.h1[j] = max_c(a + row[7], 0.0f);
  }
}

// U of lane g's layer-2 units (j0, j0 + G, ...) side by side: each 16-byte
// load of h1 feeds 4U FMAs; then each unit's relu folded into the heads.
template <int U>
SGT_HD void nn_layer2_units(const NNArgs& nn, int H, int j0, int G, float& m, float& v) {
  float acc[U];
SGT_UNROLL
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;
  for (int k = 0; k < H; k += 4) {
    float h[4];
    load4(nn.h1 + k, h);
SGT_UNROLL
    for (int u = 0; u < U; ++u) {
      float w4[4];
      load4(nn.w + (j0 + u * G) * nn.ldw + 12 + k, w4);
SGT_UNROLL
      for (int i = 0; i < 4; ++i) acc[u] = acc[u] + w4[i] * h[i];
    }
  }
SGT_UNROLL
  for (int u = 0; u < U; ++u) {
    const float* row = nn.w + (j0 + u * G) * nn.ldw;
    const float a = max_c(acc[u] + row[12 + H], 0.0f);
    m = m + row[8] * a;
    v = v + row[10] * a;
  }
}

// Lane g's layer-2 units folded into its partial heads (m, v).
SGT_HD void nn_layer2(const NNArgs& nn, int H, int g, int G, float& m, float& v) {
  m = 0.0f;
  v = 0.0f;
  const int n = H / G;  // H is a multiple of 8, G divides 8
  int u = 0;
  for (; u + 4 <= n; u += 4) nn_layer2_units<4>(nn, H, g + u * G, G, m, v);
  for (; u < n; ++u) nn_layer2_units<1>(nn, H, g + u * G, G, m, v);
}

// The whole MLP for lane L.g: layer 1, the h1 hand-off, layer 2, and the
// heads' partials summed by a butterfly (round o adds the partial of lane
// g ^ o to the lane's own), which leaves the same bits on every lane.  On
// the card the lanes run at once and exchange through shared memory and
// shuffles; the host build runs every lane's phase in turn, in the same
// order of sums, and returns lane g's result.
SGT_HD void nn_mlp(const NNArgs& nn, int H, const Lanes& L, const float* f, float& mu,
                   float& v) {
  float m, vv;
#if defined(__CUDA_ARCH__)
  nn_layer1(nn, H, f, L.g, L.G);
  __syncwarp(L.mask);
  nn_layer2(nn, H, L.g, L.G, m, vv);
  __syncwarp(L.mask);  // every lane has read h1 before the next call writes it
  for (int o = 1; o < L.G; o <<= 1) {
    m = m + __shfl_xor_sync(L.mask, m, o);
    vv = vv + __shfl_xor_sync(L.mask, vv, o);
  }
#else
  float pm[8], pv[8];
  for (int g = 0; g < L.G; ++g) nn_layer1(nn, H, f, g, L.G);
  for (int g = 0; g < L.G; ++g) nn_layer2(nn, H, g, L.G, pm[g], pv[g]);
  for (int o = 1; o < L.G; o <<= 1) {
    float qm[8], qv[8];
    for (int g = 0; g < L.G; ++g) {
      qm[g] = pm[g] + pm[g ^ o];
      qv[g] = pv[g] + pv[g ^ o];
    }
    for (int g = 0; g < L.G; ++g) {
      pm[g] = qm[g];
      pv[g] = qv[g];
    }
  }
  m = pm[L.g];
  vv = pv[L.g];
#endif
  mu = m + nn.w[9];
  v = vv + nn.w[2 * nn.ldw + 9];
}

// ---------------------------------------------------------------------------
// The whole rollout of one patient
// ---------------------------------------------------------------------------

// Pointers: params [50, B]; meal_times/meal_amounts [n_meals] (static
// schedule, may be null); rnoise [2, B] and snoise [T, B] (exogenous noise,
// may be null); sf_in [64, B] / si_in [7, B] (read when !init); out
// [6, T, B] (CGM, BG, reward, done, CHO, insulin); rst [2, B] (written when
// init; the 'nn' controller adds the tail rows: [3, B] in emit mode, [7, B]
// otherwise); sf_out [64, B] / si_out [7, B].  NN selects the 'nn'
// controller at compile time, so the pid/bb/const code (K1a) is compiled
// without it.  L: this lane of the patient's group; the rows of the
// outputs are spread over the group's lanes by their slot (out rows 0-5,
// then the learner / observation rows; rst; sf_out 0-63, then si_out).
template <bool NN>
SGT_HD void rollout_body(const RolloutCfg& c, size_t b, const float* pk,
                         const int32_t* meal_times, const float* meal_amounts,
                         const float* rnoise, const float* snoise, const float* sf_in,
                         const int32_t* si_in, float* out, float* rst, float* sf_out,
                         int32_t* si_out, const NNArgs* nn, const Lanes& L) {
  const size_t B = (size_t)c.B;
  const size_t T = (size_t)c.T;
  const int st = c.sample_time;
  const float stf = (float)st;
  const float inv_st = 1.0f / stf;
  const uint32_t lane = (uint32_t)c.lane0 + (uint32_t)b;
  const Patient p = load_patient(pk, B, b);
  const float basal = pk[(N_FIELDS + 13) * B + b];
  const float cr_raw = pk[(N_FIELDS + 14) * B + b];
  const float cf_raw = pk[(N_FIELDS + 15) * B + b];
  const float CR = cr_raw > 0.0f ? cr_raw : nanf("");
  const float CF = cf_raw > 0.0f ? cf_raw : nanf("");
  const bool random_meals = !c.deterministic && !c.scenario_static;

  float x[13], lat[4], mt[6], ma[6];
  float planned, last_CHO, eating, last_Qsto, foodtaken, last_CGM, e;
  float pid_integ, pid_prev, prev_risk, prev_cho, ctrl_prev, ins_prev, ctrl_pprev, iob;
  int32_t t_min, start_min, day, seg, lat_next, n_samp;

  if (c.init) {
    Episode ep;
    draw_episode(c, pk, B, b, lane, p.Vg, (uint32_t)c.step_offset, SITE_INIT_RESET, ep);
    for (int i = 0; i < 13; ++i) x[i] = ep.x[i];
    const float bg0 = x[12] / p.Vg;
    float cgm_hist0 = ep.cgm0, cgm_obs0 = ep.cgm0;
    if (c.exogenous_noise) {
      // the env's reset pops two noise values: [0] -> history/reward
      // window, [1] -> the first controller observation
      cgm_hist0 = clip(bg0 + rnoise[b], c.cgm_min, c.cgm_max);
      cgm_obs0 = clip(bg0 + rnoise[B + b], c.cgm_min, c.cgm_max);
    }
    if (random_meals) {
      draw_meal_plan(c, lane, (uint32_t)c.step_offset, SITE_INIT_MEAL, mt, ma);
    } else {
      for (int s = 0; s < 6; ++s) {
        mt[s] = -1.0f;
        ma[s] = 0.0f;
      }
    }
    planned = last_CHO = eating = foodtaken = 0.0f;
    last_Qsto = x[0] + x[1];
    last_CGM = cgm_obs0;
    e = ep.e;
    for (int i = 0; i < 4; ++i) lat[i] = ep.lat[i];
    pid_integ = pid_prev = prev_cho = ins_prev = iob = 0.0f;
    prev_risk = risk_of(cgm_hist0);
    ctrl_prev = ctrl_pprev = cgm_obs0;
    t_min = day = seg = n_samp = 0;
    start_min = ep.start;
    lat_next = 3;
    if (L.owns(0)) rst[b] = bg0;
    if (L.owns(1)) rst[B + b] = cgm_hist0;
  } else {
    for (int i = 0; i < 13; ++i) x[i] = sf_in[i * B + b];
    planned = sf_in[13 * B + b];
    last_CHO = sf_in[14 * B + b];
    eating = sf_in[15 * B + b];
    last_Qsto = sf_in[16 * B + b];
    foodtaken = sf_in[17 * B + b];
    last_CGM = sf_in[18 * B + b];
    e = sf_in[19 * B + b];
    for (int i = 0; i < 4; ++i) lat[i] = sf_in[(20 + i) * B + b];
    for (int s = 0; s < 6; ++s) {
      mt[s] = sf_in[(24 + s) * B + b];
      ma[s] = sf_in[(30 + s) * B + b];
    }
    pid_integ = sf_in[36 * B + b];
    pid_prev = sf_in[37 * B + b];
    prev_risk = sf_in[38 * B + b];
    prev_cho = sf_in[39 * B + b];
    ctrl_prev = sf_in[40 * B + b];
    ins_prev = sf_in[61 * B + b];
    ctrl_pprev = sf_in[62 * B + b];
    iob = sf_in[63 * B + b];
    t_min = si_in[b];
    start_min = si_in[B + b];
    day = si_in[2 * B + b];
    seg = si_in[3 * B + b];
    lat_next = si_in[4 * B + b];
    n_samp = si_in[5 * B + b];
  }

  NNLane nl{};
  float nn_log_std = 0.0f, nn_sigma = 0.0f, nn_inv_sigma = 0.0f;
  if constexpr (NN) {
    nl = nn_lane(basal);
    nn_log_std = nn->w[nn->ldw + 9];
    nn_sigma = expf(nn_log_std);
    nn_inv_sigma = expf(-nn_log_std);
  }

  for (size_t t = 0; t < T; ++t) {
    const uint32_t gstep = (uint32_t)c.step_offset + (uint32_t)t;
    // ---- controller acts on the previous step's CGM observation ----
    const float obs = ctrl_prev;
    float insulin;
    if constexpr (NN) {
      // featurize (rl/policy.py featurize_parts), the MLP, a sampled or
      // mean action, the decoder, the pump, then insulin-on-board
      float f[7], mu, v;
      nn_features(nl, ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob, f);
      nn_mlp(*nn, c.nn_hidden, L, f, mu, v);
      float raw = mu;
      if (!c.deterministic && c.nn_sample_actions) {
        uint32_t w[4];
        philox4x32_10(lane, gstep, SITE_ACTION, 0u, c.key0, c.key1, w);
        float z, z_unused;
        box_muller(w[0], w[1], z, z_unused);
        raw = mu + nn_sigma * z;
      }
      const size_t o = t * B + b;
      if (c.nn_emit) {
        // learner rows: 0-6 features, 7 value, 8 raw, 9 behaviour log-prob
        const float zl = (raw - mu) * nn_inv_sigma;
        const float row[10] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], v, raw,
                               -0.5f * zl * zl - nn_log_std - 0.5f * LOG_2PI};
SGT_UNROLL
        for (int k = 0; k < 10; ++k)
          if (L.owns(6 + k)) nn->lrn[k * T * B + o] = row[k];
      } else {
        const float row[6] = {raw, ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob};
SGT_UNROLL
        for (int k = 0; k < 6; ++k)
          if (L.owns(6 + k)) nn->obs[k * T * B + o] = row[k];
      }
      if (c.nn_residual_bb) {
        // BB therapy's command modulated by exp(scale * tanh(raw)); the
        // pump quantizes the final command
        float bolus_cmd = 0.0f;
        if (prev_cho > 0.0f) {
          const float bolus_u = (prev_cho * stf) / CR +
                                (obs > 150.0f ? 1.0f : 0.0f) * (obs - c.bb_target) / CF;
          bolus_cmd = bolus_u / stf;
        }
        const float mod = expf(c.nn_action_scale * tanhf(raw));
        insulin = quantize((basal + bolus_cmd) * mod, c.inc_basal, c.min_basal, c.max_basal);
      } else {
        float cmd = c.nn_action_scale / (1.0f + expf(-raw));
        if (c.nn_scale_by_basal) cmd = cmd * basal;
        insulin = quantize(cmd, c.inc_basal, c.min_basal, c.max_basal);
      }
      iob = iob * c.iob_decay + insulin * stf;
    } else if (c.controller == CTRL_PID) {
      const float control = c.pid_p * (obs - c.pid_target) + c.pid_i * pid_integ +
                            c.pid_d * (obs - pid_prev) / stf;
      pid_integ = pid_integ + (obs - c.pid_target) * stf;
      pid_prev = obs;
      insulin = quantize(control, c.inc_basal, c.min_basal, c.max_basal);
    } else if (c.controller == CTRL_BB) {
      const float meal_ann = prev_cho;
      float bolus_cmd = 0.0f;
      if (meal_ann > 0.0f) {
        const float bolus_u = (meal_ann * stf) / CR +
                              (obs > 150.0f ? 1.0f : 0.0f) * (obs - c.bb_target) / CF;
        bolus_cmd = bolus_u / stf;
      }
      insulin = quantize(basal, c.inc_basal, c.min_basal, c.max_basal) +
                quantize(bolus_cmd, c.inc_bolus, c.min_bolus, c.max_bolus);
    } else {
      insulin = quantize(c.const_basal, c.inc_basal, c.min_basal, c.max_basal);
    }

    // ---- a new day's meal plan, drawn when this step reaches midnight ----
    if (random_meals) {
      const int32_t day_end = (start_min + t_min + (st - 1)) / MINUTES_PER_DAY;
      if (day_end > day) {
        draw_meal_plan(c, lane, gstep, SITE_MEAL, mt, ma);
        day = day_end;
      }
    }

    const float ins_rate = insulin * 6000.0f / p.BW;  // the step's pump rate, every minute
    float CHO_acc = 0.0f, BG_acc = 0.0f, CGM_acc = 0.0f;
    for (int m = 0; m < st; ++m) {
      float meal = 0.0f;
      if (random_meals) {
        const float modf = (float)((start_min + t_min) % MINUTES_PER_DAY);
SGT_UNROLL
        for (int s = 0; s < 6; ++s) {
          if (mt[s] == modf) {  // first match wins
            meal = meal + ma[s];
            break;
          }
        }
      } else {
        for (int j = 0; j < c.n_meals; ++j)
          if (t_min == meal_times[j]) meal = meal + meal_amounts[j];
      }

      // meal announcement / eating state machine
      planned = planned + meal;
      const float to_eat = planned > 0.0f ? min_c(planned, EAT_RATE) : 0.0f;
      planned = max_c(planned - to_eat, 0.0f);
      const bool starts = (to_eat > 0.0f) && (last_CHO <= 0.0f);
      if (starts) {
        last_Qsto = x[0] + x[1];
        foodtaken = 0.0f;
      }
      bool eating_b = starts || (eating > 0.0f);
      if (eating_b) foodtaken = foodtaken + to_eat;
      const bool ends = (to_eat <= 0.0f) && (last_CHO > 0.0f);
      eating_b = eating_b && !ends;
      eating = eating_b ? 1.0f : 0.0f;
      last_CHO = to_eat;

      const float d_mg = to_eat * 1000.0f;
      const float Dbar = last_Qsto + foodtaken * 1000.0f;
      rk4_minute(p, x, d_mg, ins_rate, Dbar);
      t_min = t_min + 1;

      const float bg_m = x[12] / p.Vg;
      if (m == st - 1) {
        float cgm_m;
        if (c.exogenous_noise) {
          cgm_m = clip(bg_m + snoise[t * B + b], c.cgm_min, c.cgm_max);
        } else if (c.deterministic) {
          cgm_m = clip(bg_m, c.cgm_min, c.cgm_max);
        } else {
          const int32_t tau = (n_samp + 1) * st;
          const int32_t kk = tau / MDL_SAMPLE_TIME;
          const float u = (float)(tau - kk * MDL_SAMPLE_TIME) / (float)MDL_SAMPLE_TIME;
          if (kk + 2 >= lat_next) {  // the lattice needs its next point
            uint32_t w[4];
            philox4x32_10(lane, gstep, SITE_CGM, 0u, c.key0, c.key1, w);
            float z, z_unused;
            box_muller(w[0], w[1], z, z_unused);
            e = c.pacf * (e + z);
            lat[0] = lat[1];
            lat[1] = lat[2];
            lat[2] = lat[3];
            lat[3] = johnson(c, e);
            lat_next = lat_next + 1;
          }
          seg = kk;
          cgm_m = clip(bg_m + catmull(lat[0], lat[1], lat[2], lat[3], u), c.cgm_min, c.cgm_max);
          n_samp = n_samp + 1;
        }
        last_CGM = cgm_m;
      }
      // the CHO history records the ANNOUNCED meal (reference env.py:54,60);
      // averages multiply by float(1/st) as XLA compiles the JAX division
      CHO_acc = CHO_acc + meal * inv_st;
      BG_acc = BG_acc + bg_m * inv_st;
      CGM_acc = CGM_acc + last_CGM * inv_st;
    }

    // ---- reward / done ----
    const float risk_now = risk_of(CGM_acc);
    const float reward = c.reward_neg_risk ? -0.1f * risk_now : prev_risk - risk_now;
    const bool done = (BG_acc < c.bg_done_low) || (BG_acc > c.bg_done_high);
    const size_t o = t * B + b;
    const float row[6] = {CGM_acc, BG_acc, reward, done ? 1.0f : 0.0f, CHO_acc, insulin};
SGT_UNROLL
    for (int k = 0; k < 6; ++k)
      if (L.owns(k)) out[k * T * B + o] = row[k];

    prev_risk = risk_now;
    prev_cho = CHO_acc;
    ctrl_pprev = ctrl_prev;
    ctrl_prev = CGM_acc;
    ins_prev = insulin;

    // ---- auto-reset with fresh draws; the meal plan is kept ----
    if (done && c.autoreset && !c.deterministic) {
      Episode ep;
      draw_episode(c, pk, B, b, lane, p.Vg, gstep, SITE_RESET, ep);
      for (int i = 0; i < 13; ++i) x[i] = ep.x[i];
      planned = last_CHO = eating = foodtaken = 0.0f;
      last_Qsto = ep.x[0] + ep.x[1];
      last_CGM = ep.cgm0;
      e = ep.e;
      for (int i = 0; i < 4; ++i) lat[i] = ep.lat[i];
      pid_integ = pid_prev = prev_cho = ins_prev = iob = 0.0f;
      prev_risk = risk_of(ep.cgm0);
      ctrl_prev = ctrl_pprev = ep.cgm0;
      t_min = day = seg = n_samp = 0;
      start_min = ep.start;
      lat_next = 3;
    }
  }

  if constexpr (NN) {
    // the observation the next step would act on: its value (emit mode,
    // the GAE bootstrap) or its inputs
    if (c.nn_emit) {
      float f[7], mu, v;
      nn_features(nl, ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob, f);
      nn_mlp(*nn, c.nn_hidden, L, f, mu, v);
      if (L.owns(2)) rst[2 * B + b] = v;
    } else {
      const float row[5] = {ctrl_prev, ins_prev, prev_cho, ctrl_pprev, iob};
SGT_UNROLL
      for (int k = 0; k < 5; ++k)
        if (L.owns(2 + k)) rst[(2 + k) * B + b] = row[k];
    }
  }

  // ---- final state, the JAX kernel's plane map; planes 41..60 unused ----
  float fin[NS_F];
SGT_UNROLL
  for (int i = 0; i < 13; ++i) fin[i] = x[i];
  fin[13] = planned;
  fin[14] = last_CHO;
  fin[15] = eating;
  fin[16] = last_Qsto;
  fin[17] = foodtaken;
  fin[18] = last_CGM;
  fin[19] = e;
SGT_UNROLL
  for (int i = 0; i < 4; ++i) fin[20 + i] = lat[i];
SGT_UNROLL
  for (int s = 0; s < 6; ++s) {
    fin[24 + s] = mt[s];
    fin[30 + s] = ma[s];
  }
  fin[36] = pid_integ;
  fin[37] = pid_prev;
  fin[38] = prev_risk;
  fin[39] = prev_cho;
  fin[40] = ctrl_prev;
SGT_UNROLL
  for (int i = 41; i < 61; ++i) fin[i] = 0.0f;
  fin[61] = ins_prev;
  fin[62] = ctrl_pprev;
  fin[63] = iob;
SGT_UNROLL
  for (int i = 0; i < NS_F; ++i)
    if (L.owns(i)) sf_out[i * B + b] = fin[i];
  const int32_t fin_i[NS_I] = {t_min, start_min, day, seg, lat_next, n_samp, 0};
SGT_UNROLL
  for (int i = 0; i < NS_I; ++i)
    if (L.owns(NS_F + i)) si_out[i * B + b] = fin_i[i];
}

// K1a: the pid/bb/const controllers
SGT_HD void rollout_patient(const RolloutCfg& c, size_t b, const float* pk,
                            const int32_t* meal_times, const float* meal_amounts,
                            const float* rnoise, const float* snoise,
                            const float* sf_in, const int32_t* si_in, float* out,
                            float* rst, float* sf_out, int32_t* si_out, const Lanes& L) {
  rollout_body<false>(c, b, pk, meal_times, meal_amounts, rnoise, snoise, sf_in, si_in, out,
                      rst, sf_out, si_out, nullptr, L);
}

// K1b: the 'nn' controller
SGT_HD void rollout_patient_nn(const RolloutCfg& c, size_t b, const float* pk,
                               const int32_t* meal_times, const float* meal_amounts,
                               const float* rnoise, const float* snoise,
                               const float* sf_in, const int32_t* si_in, float* out,
                               float* rst, float* sf_out, int32_t* si_out,
                               const NNArgs& nn, const Lanes& L) {
  rollout_body<true>(c, b, pk, meal_times, meal_amounts, rnoise, snoise, sf_in, si_in, out,
                     rst, sf_out, si_out, &nn, L);
}

}  // namespace sgt
