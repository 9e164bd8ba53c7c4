// The learner's math, shared by the CUDA kernels (ppo_learner.cu) and any
// host build of this header: GAE for one lane (K2) and one fused PPO grad
// step over one shuffle block (K3).
//
// Every function is __host__ __device__.  The block routine takes its
// thread index and thread count and synchronises through SGT_SYNC, so a
// host build runs it as one thread (tid 0 of 1, no barrier) over the same
// shared-memory layout.  The math follows the plain PyTorch versions in
// simglucose_tpu_torch/ops/ppo_learner.py, which follow the JAX kernels
// simglucose_tpu/ops/pallas_ppo_learner.py::_gae_kernel and ::_tile_grads.
#pragma once

#include "rollout_math.cuh"

#if defined(__CUDA_ARCH__)
#define SGT_SYNC() __syncthreads()
#else
#define SGT_SYNC()
#endif

namespace sgt {

// ---------------------------------------------------------------------------
// K2: generalized advantage estimation, one lane
// ---------------------------------------------------------------------------

// reward/done/value: [T, B] (value may be the learner buffer's row 7, the
// same layout); tail: [B]; out: [2, T*B] (advantages, returns), column
// t*B + b.  gl = gamma * lam rounded once on the host.
SGT_HD void gae_lane(int T, size_t B, size_t b, const float* reward, const float* done,
                     const float* value, const float* tail, float gamma, float gl,
                     float* out) {
  const size_t TB = (size_t)T * B;
  float adv_next = 0.0f, v_next = tail[b];
  for (int t = T - 1; t >= 0; --t) {
    const size_t o = (size_t)t * B + b;
    const float nt = 1.0f - done[o];
    const float vt = value[o];
    const float delta = reward[o] + gamma * v_next * nt - vt;
    const float adv = delta + gl * nt * adv_next;
    out[o] = adv;
    out[TB + o] = adv + vt;
    adv_next = adv;
    v_next = vt;
  }
}

// ---------------------------------------------------------------------------
// K3: one PPO grad step over a shuffle block
// ---------------------------------------------------------------------------

constexpr int PPO_TILE = 32;  // rows per tile

enum Act { ACT_RELU = 0, ACT_TANH = 1 };

struct PPOArgs {
  const float* main;    // [10, N]: 0-6 obs, 7 value (not read), 8 raw, 9 logp_old
  const float* advret;  // [2, N]: adv, ret
  const int64_t* perm;  // [bpm] shuffle-block ids of this minibatch
  const float* w1;      // [7, H]
  const float* b1;      // [H]
  const float* w2;      // [H, H]
  const float* b2;      // [H]
  const float* wh;      // [H, 2] (mu, v)
  const float* bh;      // [2]
  const float* scal;    // [4]: log_std, adv_mean, 1/(adv_std+1e-8), 1/n
  float* partial;       // [bpm, ppo_out_len(H)]
  int64_t N;
  int bs, H, act;
  float clip_lo, clip_hi, vf_coef;
};

// Output of one block, and of the reduction over blocks: dW1 [7, H], db1
// [H], dW2 [H, H], db2 [H], dW_head [H, 2], db_head [2], then the sums
// (dlog_std, pg, v).
SGT_HD int ppo_out_len(int H) { return 7 * H + H + H * H + H + 2 * H + 2 + 3; }

// Shared-memory layout in floats: weights (W2 padded to rows of H+1), one
// row tile, its activations, and the block's accumulators (the output
// layout above, so the block writes them out as they stand).
struct PPOSmem {
  float *w1, *b1, *w2, *b2, *wh, *bh;
  float *x, *raw, *lpo, *adv, *ret, *dmu, *dv, *rows;
  float *h1, *h2, *dg;
  float* acc;
};

SGT_HD size_t ppo_smem_floats(int H) {
  const size_t R = PPO_TILE;
  return (size_t)(7 * H + H + H * (H + 1) + H + 2 * H + 2) + R * 8 + 6 * R + 3 * R +
         3 * R * (size_t)H + (size_t)ppo_out_len(H);
}

SGT_HD PPOSmem ppo_smem(float* s, int H) {
  const int R = PPO_TILE;
  PPOSmem m;
  m.w1 = s; s += 7 * H;
  m.b1 = s; s += H;
  m.w2 = s; s += H * (H + 1);
  m.b2 = s; s += H;
  m.wh = s; s += 2 * H;
  m.bh = s; s += 2;
  m.x = s; s += R * 8;
  m.raw = s; s += R;
  m.lpo = s; s += R;
  m.adv = s; s += R;
  m.ret = s; s += R;
  m.dmu = s; s += R;
  m.dv = s; s += R;
  m.rows = s; s += 3 * R;
  m.h1 = s; s += R * H;
  m.h2 = s; s += R * H;
  m.dg = s; s += R * H;
  m.acc = s;
  return m;
}

SGT_HD float act_f(int act, float p) { return act == ACT_RELU ? max_c(p, 0.0f) : tanhf(p); }

// the activation's derivative from its output
SGT_HD float act_grad(int act, float h) {
  return act == ACT_RELU ? (h > 0.0f ? 1.0f : 0.0f) : 1.0f - h * h;
}

// One row of the clipped-surrogate loss and its gradient with respect to
// (mu, v), exactly _tile_grads's per-lane math.  rows: (dlog_std, pg, v)
// contributions.
SGT_HD void ppo_row(float raw, float logp_old, float adv, float ret, float mu, float v,
                    float log_std, float es, float adv_mean, float adv_rstd, float inv_n,
                    float clip_lo, float clip_hi, float vf_coef, float& dmu, float& dv,
                    float* rows) {
  const float z = (raw - mu) * es;
  const float logp = -0.5f * z * z - log_std - 0.5f * LOG_2PI;
  const float ratio = expf(logp - logp_old);
  const float adv_n = (adv - adv_mean) * adv_rstd;
  const float pg1 = ratio * adv_n;
  const float pg2 = clip(ratio, clip_lo, clip_hi) * adv_n;
  // d min(pg1, pg2) / d ratio: the unclipped path, or the clipped one while
  // the clip is inactive
  const float in_bounds = (ratio >= clip_lo && ratio <= clip_hi) ? 1.0f : 0.0f;
  const float g_min = pg1 <= pg2 ? 1.0f : in_bounds;
  const float dratio = (-inv_n) * adv_n * g_min;
  const float dlogp = dratio * ratio;
  dmu = dlogp * z * es;
  dv = (vf_coef * inv_n) * (v - ret);
  rows[0] = dlogp * (z * z - 1.0f);
  rows[1] = -(pg1 < pg2 ? pg1 : pg2);
  rows[2] = 0.5f * ((v - ret) * (v - ret));
}

// Forward, loss and hand-derived backward over the bs rows of shuffle block
// a.perm[blk], in tiles of PPO_TILE rows; the block's gradient and loss
// sums go to a.partial[blk].  Each accumulator has one owning thread, and
// every sum runs in a fixed order, so a step is deterministic.
SGT_HD void ppo_grad_block(const PPOArgs& a, int blk, float* smem, int tid, int nthr) {
  const int H = a.H, R = PPO_TILE, act = a.act;
  const int L = ppo_out_len(H);
  const PPOSmem m = ppo_smem(smem, H);
  const float log_std = a.scal[0], adv_mean = a.scal[1], adv_rstd = a.scal[2];
  const float inv_n = a.scal[3];
  const float es = expf(-log_std);

  for (int i = tid; i < 7 * H; i += nthr) m.w1[i] = a.w1[i];
  for (int i = tid; i < H * H; i += nthr) m.w2[(i / H) * (H + 1) + i % H] = a.w2[i];
  for (int i = tid; i < H; i += nthr) {
    m.b1[i] = a.b1[i];
    m.b2[i] = a.b2[i];
  }
  for (int i = tid; i < 2 * H; i += nthr) m.wh[i] = a.wh[i];
  for (int i = tid; i < 2; i += nthr) m.bh[i] = a.bh[i];
  for (int i = tid; i < L; i += nthr) m.acc[i] = 0.0f;
  float* a_dw1 = m.acc;
  float* a_db1 = a_dw1 + 7 * H;
  float* a_dw2 = a_db1 + H;
  float* a_db2 = a_dw2 + H * H;
  float* a_dwh = a_db2 + H;
  float* a_dbh = a_dwh + 2 * H;
  float* a_sum = a_dbh + 2;
  SGT_SYNC();

  const int64_t col0 = a.perm[blk] * (int64_t)a.bs;
  for (int r0 = 0; r0 < a.bs; r0 += R) {
    const int n_rows = a.bs - r0 < R ? a.bs - r0 : R;
    // ---- gather the tile (rows past the block's end are zero) ----
    for (int i = tid; i < R * 8; i += nthr) {
      const int r = i / 8, f = i % 8;
      m.x[i] = (r < n_rows && f < 7) ? a.main[f * a.N + col0 + r0 + r] : 0.0f;
    }
    for (int r = tid; r < R; r += nthr) {
      const bool in = r < n_rows;
      const int64_t col = col0 + r0 + r;
      m.raw[r] = in ? a.main[8 * a.N + col] : 0.0f;
      m.lpo[r] = in ? a.main[9 * a.N + col] : 0.0f;
      m.adv[r] = in ? a.advret[col] : 0.0f;
      m.ret[r] = in ? a.advret[a.N + col] : 0.0f;
    }
    SGT_SYNC();
    // ---- forward: h1 = f(x W1 + b1), h2 = f(h1 W2 + b2) ----
    for (int i = tid; i < R * H; i += nthr) {
      const int r = i / H, j = i % H;
      float s = 0.0f;
      for (int k = 0; k < 7; ++k) s = s + m.x[r * 8 + k] * m.w1[k * H + j];
      m.h1[i] = act_f(act, s + m.b1[j]);
    }
    SGT_SYNC();
    for (int i = tid; i < R * H; i += nthr) {
      const int r = i / H, j = i % H;
      float s = 0.0f;
      for (int k = 0; k < H; ++k) s = s + m.h1[r * H + k] * m.w2[k * (H + 1) + j];
      m.h2[i] = act_f(act, s + m.b2[j]);
    }
    SGT_SYNC();
    // ---- heads and the per-row loss ----
    for (int r = tid; r < R; r += nthr) {
      float dmu = 0.0f, dv = 0.0f, rows[3] = {0.0f, 0.0f, 0.0f};
      if (r < n_rows) {
        float mu = 0.0f, v = 0.0f;
        for (int j = 0; j < H; ++j) {
          mu = mu + m.h2[r * H + j] * m.wh[2 * j];
          v = v + m.h2[r * H + j] * m.wh[2 * j + 1];
        }
        ppo_row(m.raw[r], m.lpo[r], m.adv[r], m.ret[r], mu + m.bh[0], v + m.bh[1], log_std,
                es, adv_mean, adv_rstd, inv_n, a.clip_lo, a.clip_hi, a.vf_coef, dmu, dv,
                rows);
      }
      m.dmu[r] = dmu;
      m.dv[r] = dv;
      for (int q = 0; q < 3; ++q) m.rows[r * 3 + q] = rows[q];
    }
    SGT_SYNC();
    // ---- backward through the heads: dg2, dW_head, db_head, sums ----
    for (int i = tid; i < R * H; i += nthr) {
      const int r = i / H, j = i % H;
      const float dh = m.dmu[r] * m.wh[2 * j] + m.dv[r] * m.wh[2 * j + 1];
      m.dg[i] = dh * act_grad(act, m.h2[i]);
    }
    for (int i = tid; i < 2 * H; i += nthr) {
      const int j = i / 2;
      const float* d = (i % 2) ? m.dv : m.dmu;
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = s + m.h2[r * H + j] * d[r];
      a_dwh[i] += s;
    }
    for (int i = tid; i < 5; i += nthr) {
      float s = 0.0f;
      if (i < 2) {
        const float* d = i ? m.dv : m.dmu;
        for (int r = 0; r < R; ++r) s = s + d[r];
        a_dbh[i] += s;
      } else {
        for (int r = 0; r < R; ++r) s = s + m.rows[r * 3 + (i - 2)];
        a_sum[i - 2] += s;
      }
    }
    SGT_SYNC();
    // ---- dW2 = h1^T dg2, db2, and dg1 = (dg2 W2^T) f'(h1) into h2 ----
    for (int i = tid; i < H * H; i += nthr) {
      const int k = i / H, j = i % H;
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = s + m.h1[r * H + k] * m.dg[r * H + j];
      a_dw2[i] += s;
    }
    for (int j = tid; j < H; j += nthr) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = s + m.dg[r * H + j];
      a_db2[j] += s;
    }
    for (int i = tid; i < R * H; i += nthr) {
      const int r = i / H, k = i % H;
      float s = 0.0f;
      for (int j = 0; j < H; ++j) s = s + m.w2[k * (H + 1) + j] * m.dg[r * H + j];
      m.h2[i] = s * act_grad(act, m.h1[i]);
    }
    SGT_SYNC();
    // ---- dW1 = x^T dg1 (the 7 observation rows), db1 ----
    for (int i = tid; i < 7 * H; i += nthr) {
      const int k = i / H, j = i % H;
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = s + m.x[r * 8 + k] * m.h2[r * H + j];
      a_dw1[i] += s;
    }
    for (int j = tid; j < H; j += nthr) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = s + m.h2[r * H + j];
      a_db1[j] += s;
    }
    SGT_SYNC();
  }
  float* out = a.partial + (size_t)blk * L;
  for (int i = tid; i < L; i += nthr) out[i] = m.acc[i];
}

// Entry i of the step's output: the blocks' partials [n_blk, L] summed in
// block order.
SGT_HD float block_sum(const float* partial, int n_blk, int L, int i) {
  float s = 0.0f;
  for (int k = 0; k < n_blk; ++k) s += partial[(size_t)k * L + i];
  return s;
}

}  // namespace sgt
