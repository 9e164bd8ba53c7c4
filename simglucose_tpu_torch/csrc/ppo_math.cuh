// The learner's math, shared by the CUDA kernels (ppo_learner.cu) and any
// host build of this header: GAE for one lane (K2), one fused PPO grad step
// over one shuffle block (K3 over the [10, N] + [2, N] buffers, K4 over the
// [12, N] buffer), and the optimizer phases of the whole-learner kernel K5.
//
// Every function is __host__ __device__.  The block routine takes its
// thread index and thread count and synchronises through SGT_SYNC, so a
// host build runs it as one thread (tid 0 of 1, no barrier) over the same
// shared-memory layout.  The math follows the plain PyTorch versions in
// simglucose_tpu_torch/ops/ppo_learner.py, which follow the JAX kernels
// simglucose_tpu/ops/pallas_ppo_learner.py::_gae_kernel and ::_tile_grads;
// the optimizer follows FlatAdam in simglucose_tpu_torch/rl/ppo.py.
#pragma once

#include "rollout_math.cuh"

#if defined(__CUDA_ARCH__)
#define SGT_SYNC() __syncthreads()
#else
#define SGT_SYNC()
#endif

namespace sgt {

// A load of data that another block of the same launch may have written
// before a grid-wide barrier (K5, Coherent): through L2 (ld.global.cg),
// never a stale line of the SM's own L1.  Otherwise, and in a host build, a
// plain load: K3/K4 keep the code they were timed with (the cg loads in
// their block routine cost them ~20% on the H100).
template <bool Coherent>
SGT_HD float ld(const float* p) {
#if defined(__CUDA_ARCH__)
  if (Coherent) return __ldcg(p);
#endif
  return *p;
}
SGT_HD float ld_cg(const float* p) { return ld<true>(p); }

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
// every sum runs in a fixed order, so a step is deterministic.  Coherent:
// the weights and scalars come from K5's previous optimizer phase.
template <bool Coherent = false>
SGT_HD void ppo_grad_block(const PPOArgs& a, int blk, float* smem, int tid, int nthr) {
  const int H = a.H, R = PPO_TILE, act = a.act;
  const int L = ppo_out_len(H);
  const PPOSmem m = ppo_smem(smem, H);
  const float log_std = ld<Coherent>(a.scal), adv_mean = ld<Coherent>(a.scal + 1);
  const float adv_rstd = ld<Coherent>(a.scal + 2), inv_n = ld<Coherent>(a.scal + 3);
  const float es = expf(-log_std);

  for (int i = tid; i < 7 * H; i += nthr) m.w1[i] = ld<Coherent>(a.w1 + i);
  for (int i = tid; i < H * H; i += nthr)
    m.w2[(i / H) * (H + 1) + i % H] = ld<Coherent>(a.w2 + i);
  for (int i = tid; i < H; i += nthr) {
    m.b1[i] = ld<Coherent>(a.b1 + i);
    m.b2[i] = ld<Coherent>(a.b2 + i);
  }
  for (int i = tid; i < 2 * H; i += nthr) m.wh[i] = ld<Coherent>(a.wh + i);
  for (int i = tid; i < 2; i += nthr) m.bh[i] = ld<Coherent>(a.bh + i);
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

// K4's arguments: the same routine over the 12-row buffer [12, N] (0-6 obs,
// 7 zero, 8 raw, 9 logp_old, 10 adv, 11 ret) in a.main, whose rows 0-9 have
// K3's layout; the adv/ret rows are read at row 10 of the same buffer.
SGT_HD PPOArgs ppo_grad12_args(PPOArgs a) {
  a.advret = a.main + 10 * a.N;
  return a;
}

// Entry i of the step's output: the blocks' partials [n_blk, L] summed in
// block order.
SGT_HD float block_sum(const float* partial, int n_blk, int L, int i) {
  float s = 0.0f;
  for (int k = 0; k < n_blk; ++k) s += ld_cg(partial + (size_t)k * L + i);
  return s;
}

// ---------------------------------------------------------------------------
// K5: every epoch x minibatch grad step, the global-norm clip and Adam
// ---------------------------------------------------------------------------

// The policy's parameters in ravel order (the port's flat vector): w1 [7,
// H], b1 [H], w2 [H, H], b2 [H], w_mu [H], b_mu, log_std, w_v [H], b_v.
SGT_HD int ppo_n_params(int H) { return 9 * H + H * H + 2 * H + 3; }
SGT_HD int ppo_log_std_index(int H) { return 10 * H + H * H + 1; }

// Flat parameter i's slot in the grad step's output layout, which is also
// the layout of the weights the grad step reads (log_std: the dlog_std sum).
SGT_HD int flat_to_out(int H, int i) {
  const int o = 9 * H + H * H;  // w1, b1, w2, b2: the same in both layouts
  if (i < o) return i;
  i -= o;
  if (i < H) return o + 2 * i;                        // w_mu: dW_head[:, 0]
  if (i == H) return o + 2 * H;                       // b_mu: db_head[0]
  if (i == H + 1) return o + 2 * H + 2;               // log_std: the dlog_std sum
  if (i < 2 * H + 2) return o + 2 * (i - H - 2) + 1;  // w_v: dW_head[:, 1]
  return o + 2 * H + 1;                               // b_v: db_head[1]
}

struct EpochArgs {
  PPOArgs g;             // main: the [12, N] buffer (advret: see ppo_grad12_args);
                         // w1..bh: into wk; perm and scal are set per minibatch
  const int64_t* perm;   // [n_mb * nblk] shuffle-block ids, minibatch-major
  float* stats;          // [n_mb, 8]: log_std at the step (row 0 from the
                         // host, later rows written by the kernel), adv_mean,
                         // 1/(adv_std+1e-8), 1/n, c1, c2, 0, 0
  float* wk;             // [ppo_out_len(H) - 3] the weights in the grad step's layout
  float* params;         // [P] ravel order
  float* mu;             // [P] Adam first moment
  float* nu;             // [P] Adam second moment
  float* grad;           // [P] scratch: this minibatch's gradient
  float* norm_part;      // [nblk] scratch: each block's sum of squares
  float* aux;            // [n_mb, 4]: pg mean, v mean, entropy, |g|
  int n_mb, nblk;
  float b1, omb1, b2, omb2, eps, neg_lr, max_norm, ent_coef, n_rows, ent_const;
};

// Minibatch k's grad-step arguments (phase 1): its shuffle blocks and its
// row of stats.
SGT_HD PPOArgs epoch_step_args(const EpochArgs& e, int k) {
  PPOArgs a = ppo_grad12_args(e.g);
  a.perm = e.perm + (size_t)k * e.nblk;
  a.scal = e.stats + 8 * (size_t)k;
  return a;
}

// Block blk's contiguous slice [lo, hi) of the P parameters.
SGT_HD void epoch_slice(int P, int nblk, int blk, int& lo, int& hi) {
  const int per = (P + nblk - 1) / nblk;
  lo = blk * per < P ? blk * per : P;
  hi = lo + per < P ? lo + per : P;
}

// Phase 2 of a minibatch, block blk: its slice of the gradient (every
// block's partial summed in block order, the entropy term folded into
// log_std) into e.grad, and the slice's sum of squares into norm_part[blk].
SGT_HD void epoch_reduce(const EpochArgs& e, int blk, int tid, int nthr) {
  const int H = e.g.H, L = ppo_out_len(H), ls = ppo_log_std_index(H);
  int lo, hi;
  epoch_slice(ppo_n_params(H), e.nblk, blk, lo, hi);
  for (int i = lo + tid; i < hi; i += nthr) {
    const float s = block_sum(e.g.partial, e.nblk, L, flat_to_out(H, i));
    e.grad[i] = i == ls ? s - e.ent_coef : s;
  }
  SGT_SYNC();
  if (tid == 0) {
    float sq = 0.0f;
    for (int i = lo; i < hi; ++i) sq += e.grad[i] * e.grad[i];
    e.norm_part[blk] = sq;
  }
}

// Phase 3 of minibatch k, block blk: the global norm (every block sums the
// parts in block order, so all get the same value), FlatAdam's clip (scale
// by max_norm/|g| when |g| >= max_norm, no epsilon) and Adam step on its
// slice.  The new weights also go to wk, log_std to the next minibatch's
// stats row; block 0 writes minibatch k's aux row.
SGT_HD void epoch_adam(const EpochArgs& e, int k, int blk, int tid, int nthr) {
  const int H = e.g.H, L = ppo_out_len(H), ls = ppo_log_std_index(H);
  float sq = 0.0f;
  for (int b = 0; b < e.nblk; ++b) sq += ld_cg(e.norm_part + b);
  const float gn = sqrtf(sq);
  const bool clipped = !(gn < e.max_norm);
  const float* st = e.stats + 8 * (size_t)k;
  const float c1 = st[4], c2 = st[5];
  int lo, hi;
  epoch_slice(ppo_n_params(H), e.nblk, blk, lo, hi);
  for (int i = lo + tid; i < hi; i += nthr) {
    float g = e.grad[i];
    if (clipped) g = (g / gn) * e.max_norm;
    const float m = e.omb1 * g + e.b1 * e.mu[i];
    const float v = e.omb2 * (g * g) + e.b2 * e.nu[i];
    e.mu[i] = m;
    e.nu[i] = v;
    const float w = e.params[i] + ((m / c1) / (sqrtf(v / c2) + e.eps)) * e.neg_lr;
    e.params[i] = w;
    if (i != ls)
      e.wk[flat_to_out(H, i)] = w;
    else if (k + 1 < e.n_mb)
      e.stats[8 * (size_t)(k + 1)] = w;
  }
  if (blk == 0 && tid == 0) {
    float* row = e.aux + 4 * (size_t)k;
    row[0] = block_sum(e.g.partial, e.nblk, L, L - 2) / e.n_rows;
    row[1] = block_sum(e.g.partial, e.nblk, L, L - 1) / e.n_rows;
    row[2] = ld_cg(st) + e.ent_const;
    row[3] = gn;
  }
}

}  // namespace sgt
