// The learner's math, shared by the CUDA kernels (ppo_learner.cu) and any
// host build of this header: GAE for one lane over one chunk of time (K2),
// one fused PPO grad step over one shuffle block (K3 over the [10, N] +
// [2, N] buffers, K4 over the [12, N] buffer), and the optimizer phases of
// the whole-learner kernel K5.
//
// Every function is __host__ __device__.  The block routine takes its
// thread index and thread count and synchronises through SGT_SYNC, so a
// host build runs it as one thread (tid 0 of 1, no barrier) over the same
// shared-memory layout.  The math follows the plain PyTorch versions in
// simglucose_tpu_torch/ops/ppo_learner.py, which follow the JAX kernels
// simglucose_tpu/ops/pallas_ppo_learner.py::_gae_kernel and ::_tile_grads;
// the optimizer follows FlatAdam in simglucose_tpu_torch/rl/ppo.py.
//
// The grad step has two instantiations, as the JAX kernels' compute_dtype:
// float32, and bfloat16 (Bf16), which rounds both operands of each of its
// products to bfloat16 (bf16_round) and accumulates in float32, its H x H
// products on the tensor cores (mma_bf16); the activations the derivatives
// read and the bias sums stay float32.
#pragma once

#include <cstring>

#include "rollout_math.cuh"

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#endif

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

// x rounded to the nearest bfloat16, ties to even, and back to float: the
// cast of a matmul operand to bfloat16.  The card's cvt instruction, and in
// a host build the same rounding on the bits: a subnormal rounds like any
// other value, a finite value from halfway past the largest bfloat16 up
// rounds to inf, inf stays inf and NaN stays NaN (the quiet NaN 0x7fff).
SGT_HD float bf16_round(float x) {
#if defined(__CUDA_ARCH__)
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    u = 0x7fff0000u;
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
    u &= 0xffff0000u;
  }
  std::memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// A product operand at the grad step's compute dtype.
template <bool Bf16>
SGT_HD float rnd(float x) {
  return Bf16 ? bf16_round(x) : x;
}

// ---------------------------------------------------------------------------
// K2: generalized advantage estimation
// ---------------------------------------------------------------------------
//
// reward/done/value: [T, B] (value may be the learner buffer's row 7, the
// same layout); tail: [B]; out: [2, T*B] (advantages, returns), column
// t*B + b.  gl = gamma * lam rounded once on the host.  The kernel
// (ppo_learner.cu::gae_kernel) gives each warp GAE_LANES consecutive lanes
// and walks time in chunks of GAE_ROWS rows, from the last chunk to the
// first, each chunk's tiles of reward, done and value staged in shared
// memory; gae_rows is one lane's walk of one chunk.

constexpr int GAE_LANES = 32;  // the lanes (columns) of a warp
constexpr int GAE_ROWS = 32;   // the time rows of a chunk

// The chunks of a T-step walk.
SGT_HD int gae_chunks(int T) { return (T + GAE_ROWS - 1) / GAE_ROWS; }

// Chunk k of the walk (k = 0 the last chunk of time): its first row t0 and
// its n rows (n < GAE_ROWS only for the first chunk of time).
SGT_HD void gae_chunk(int T, int k, int& t0, int& n) {
  t0 = (gae_chunks(T) - 1 - k) * GAE_ROWS;
  n = T - t0 < GAE_ROWS ? T - t0 : GAE_ROWS;
}

// The recurrence's carry: the advantage and the value of step t + 1.
struct GaeCarry {
  float adv, v;
};

#if defined(__CUDACC__)
#define SGT_GAE_UNROLL _Pragma("unroll 8")
#else
#define SGT_GAE_UNROLL
#endif

// One lane's rows t0 + n - 1 .. t0 of a chunk, in the JAX kernel's order
// and arithmetic: r/d/v point at the lane's element of the chunk's first
// row in tiles of row stride ld floats; adv/ret at the lane's column of
// out's rows 0 and 1 at row t0 (row stride B).
SGT_HD void gae_rows(int n, const float* r, const float* d, const float* v, int ld, float* adv,
                     float* ret, size_t B, float gamma, float gl, GaeCarry& c) {
  SGT_GAE_UNROLL
  for (int i = n - 1; i >= 0; --i) {
    const float nt = 1.0f - d[i * ld];
    const float vt = v[i * ld];
    const float delta = r[i * ld] + gamma * c.v * nt - vt;
    const float a = delta + gl * nt * c.adv;
    adv[i * B] = a;
    ret[i * B] = a + vt;
    c.adv = a;
    c.v = vt;
  }
}

// ---------------------------------------------------------------------------
// K3: one PPO grad step over a shuffle block
// ---------------------------------------------------------------------------

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
  float* partial;       // [bpm * split, ppo_out_len(H)]
  int64_t N;
  int bs, H, act;
  int split;            // work items (K3/K4: CUDA blocks) per shuffle block, each a
                        // contiguous 1/split of its rows
  float clip_lo, clip_hi, vf_coef;
  int bf16;             // the compute dtype: 0 float32, 1 bfloat16 (the launcher's
                        // choice of instantiation; the block routine's Bf16).  Last,
                        // in what was the struct's padding: the other fields keep
                        // their offsets
};

// Output of one block, and of the reduction over blocks: dW1 [7, H], db1
// [H], dW2 [H, H], db2 [H], dW_head [H, 2], db_head [2], then the sums
// (dlog_std, pg, v).
SGT_HD int ppo_out_len(int H) { return 7 * H + H + H * H + H + 2 * H + 2 + 3; }

// The short sums over rows (dW_head, db_head, the loss sums, db2, dW1, db1)
// run as items of this many rows, one accumulator copy per such split of a
// tile, folded in split order at the end of the block.
constexpr int PPO_SPLIT_ROWS = 16;

// Rows per tile: R x H = 4096 outputs fill 256 threads' 4 x 4 micro-tiles
// (R = 64 at H = 64, 32 at H = 128, where a larger R would not fit in
// shared memory), R a power of two in [32, 128].
SGT_HD int ppo_tile_rows(int H) { return H <= 32 ? 128 : (H <= 64 ? 64 : 32); }
SGT_HD int ppo_row_splits(int H) { return ppo_tile_rows(H) / PPO_SPLIT_ROWS; }
// The bfloat16 instantiation's rows per tile: its layout has the room for
// R = 64 at H = 128 (fewer, longer tiles: each barrier and short phase
// serves twice the rows).
SGT_HD int ppo_tile_rows_bf16(int H) { return H <= 32 ? 128 : 64; }
// H rounded up to a multiple of 4; the weight rows' stride (H4 + 4, so that
// a quarter-warp's 16-byte loads from 8 consecutive rows hit 32 banks)
SGT_HD int ppo_h4(int H) { return (H + 3) / 4 * 4; }
SGT_HD int ppo_wstride(int H) { return ppo_h4(H) + 4; }
// The output layout without dW2: dW1, db1, db2, dW_head, db_head, the sums.
SGT_HD int ppo_small_len(int H) { return 11 * H + 5; }

// Shared-memory layout in floats, every region but the last two a multiple
// of 4 floats (16-byte loads).  The activations are feature-major, [H4, R+4]
// (the TPU kernel's [H, R] layout; R+4 so that a quarter-warp's 16-byte
// loads from 8 consecutive features hit 32 banks), and the weights are
// padded with zeros to H4 columns (w1 also to an 8th row): a padded feature
// stays 0 through every product, so the products walk multiples of 4 and
// guard only their writes to the accumulators.  Two tile-input buffers (the
// next tile's gather overlaps this one's last phases): x^T [8, R+4] (row 7
// zero), then raw, logp_old, adv, ret [R].  The head partials are [2, H4/4,
// R+4]; dW2's accumulator [H, H]; one copy of the other accumulators per
// row split.  The bfloat16 instantiation's layout (ppo_smem_bf16) holds the
// tensor cores' operands as bfloat16 in place of w2, dg and dw2.
struct PPOSmem {
  float *w1, *w2, *b1, *b2, *whm, *whv, *bh;
  float *in0, *in1;
  float *dmu, *dv, *rows;
  float *h1, *h2, *dg;
  float* hp;
  float* dw2;
  float* split;
  uint16_t *w2b, *h1b, *dgb;  // Bf16: W2 [HB, HB+8], h1 and dg2 [HB, R+8]
};

SGT_HD size_t ppo_smem_floats(int H) {
  const size_t R = ppo_tile_rows(H), RP = R + 4, H4 = ppo_h4(H), HS = ppo_wstride(H);
  return 8 * HS + H4 * HS + 4 * H4 + 4 + 2 * (8 * RP + 4 * R) + 5 * R + 3 * H4 * RP +
         2 * (H4 / 4) * RP + (size_t)H * H + (size_t)ppo_row_splits(H) * ppo_small_len(H);
}

SGT_HD PPOSmem ppo_smem(float* s, int H) {
  const int R = ppo_tile_rows(H), RP = R + 4, H4 = ppo_h4(H), HS = ppo_wstride(H);
  PPOSmem m;
  m.w1 = s; s += 8 * HS;
  m.w2 = s; s += H4 * HS;
  m.b1 = s; s += H4;
  m.b2 = s; s += H4;
  m.whm = s; s += H4;
  m.whv = s; s += H4;
  m.bh = s; s += 4;
  m.in0 = s; s += 8 * RP + 4 * R;
  m.in1 = s; s += 8 * RP + 4 * R;
  m.dmu = s; s += R;
  m.dv = s; s += R;
  m.rows = s; s += 3 * R;
  m.h1 = s; s += H4 * RP;
  m.h2 = s; s += H4 * RP;
  m.dg = s; s += H4 * RP;
  m.hp = s; s += 2 * (H4 / 4) * RP;
  m.dw2 = s; s += H * H;
  m.split = s;
  return m;
}

// The bf16 products' operand extent: H up to a multiple of 32 (a warp's
// group of four 8-column tiles), zero past H.
SGT_HD int ppo_hb(int H) { return (H + 31) / 32 * 32; }
// H4 up to a multiple of 16: the products' depth over features.
SGT_HD int ppo_h16(int H) { return (ppo_h4(H) + 15) / 16 * 16; }
// dW2 = h1^T dg2 as groups of four 16 x 8 mma tiles: 16 rows of h1's
// features by 32 of dg2's each.
SGT_HD int mma_dw2_groups(int H) { return ppo_h16(H) / 16 * (ppo_hb(H) / 32); }

// The bfloat16 instantiation's layout: the float32 regions but w2, dg and
// dw2 (W2 and dg2 are only product operands; dW2 sums in registers), the
// biases and head weights zero-padded to HB (the epilogues read them for
// every column of a group without a branch), then,
// 16-byte aligned, the tensor cores' bfloat16 operands, each row 8 elements
// longer than its extent so that ldmatrix's eight 16-byte rows hit all 32
// banks: W2 [HB, HB+8] (W2[k][n], zero past H), h1 and dg2 [HB, R+8]
// (feature-major, the float32 h1 and dg2 rounded; zero past H4).
SGT_HD size_t ppo_smem_bf16_floats(int H) {
  const size_t R = ppo_tile_rows_bf16(H), RP = R + 4, H4 = ppo_h4(H), HS = ppo_wstride(H);
  return (8 * HS + 4 * (size_t)ppo_hb(H) + 4 + 2 * (8 * RP + 4 * R) + 5 * R + 2 * H4 * RP +
          2 * (H4 / 4) * RP + R / PPO_SPLIT_ROWS * (size_t)ppo_small_len(H) + 3) / 4 * 4;
}

SGT_HD size_t ppo_smem_bytes(int H, bool bf16) {
  if (!bf16) return ppo_smem_floats(H) * sizeof(float);
  const size_t R = ppo_tile_rows_bf16(H), HB = ppo_hb(H);
  return ppo_smem_bf16_floats(H) * sizeof(float) + 2 * (HB * (HB + 8) + 2 * HB * (R + 8));
}

SGT_HD PPOSmem ppo_smem_bf16(float* s, int H) {
  const int R = ppo_tile_rows_bf16(H), RP = R + 4, H4 = ppo_h4(H), HS = ppo_wstride(H);
  const int HB = ppo_hb(H);
  PPOSmem m;
  float* const base = s;
  m.w2 = m.dg = m.dw2 = nullptr;
  m.w1 = s; s += 8 * HS;
  m.b1 = s; s += HB;
  m.b2 = s; s += HB;
  m.whm = s; s += HB;
  m.whv = s; s += HB;
  m.bh = s; s += 4;
  m.in0 = s; s += 8 * RP + 4 * R;
  m.in1 = s; s += 8 * RP + 4 * R;
  m.dmu = s; s += R;
  m.dv = s; s += R;
  m.rows = s; s += 3 * R;
  m.h1 = s; s += H4 * RP;
  m.h2 = s; s += H4 * RP;
  m.hp = s; s += 2 * (H4 / 4) * RP;
  m.split = s;
  uint16_t* b = reinterpret_cast<uint16_t*>(base + ppo_smem_bf16_floats(H));
  m.w2b = b; b += HB * (HB + 8);
  m.h1b = b; b += HB * (R + 8);
  m.dgb = b;
  return m;
}

template <bool Bf16>
SGT_HD PPOSmem ppo_smem_for(float* s, int H) {
  if constexpr (Bf16) return ppo_smem_bf16(s, H);
  else return ppo_smem(s, H);
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

// Four consecutive floats of shared memory, 16-byte aligned: one 16-byte
// load or store on the card, four scalar ones in a host build.
SGT_HD void ld4(const float* p, float (&v)[4]) {
#if defined(__CUDA_ARCH__)
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

SGT_HD void st4(float* p, const float (&v)[4]) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// One 4 x 4 register micro-tile of C = A B, c[i][j] = sum over k < K (a
// multiple of 4, in order) of A(m_i, k) B(k, n_j), walking k in blocks of
// four with 16-byte loads: 8 loads per 64 FMAs.  AK: A(m_i, k) = a[ao[i] +
// k] (each row runs along k); else A(m_i, k) = a[k*as + ao[0] + i] (the
// tile's rows are consecutive).  BK and B(k, n_j) likewise, with b, bs, bo.
template <bool AK, bool BK>
SGT_HD void micro_product(float (&c)[4][4], const float* a, int as, const int (&ao)[4],
                          const float* b, int bs, const int (&bo)[4], int K) {
  SGT_UNROLL
  for (int i = 0; i < 4; ++i) {
    SGT_UNROLL
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4], t[4];  // av[q][i] = A(m_i, k+q), bv[q][j] = B(k+q, n_j)
    SGT_UNROLL
    for (int i = 0; i < 4; ++i) {
      if (AK) {
        ld4(a + ao[i] + k, t);
        SGT_UNROLL
        for (int q = 0; q < 4; ++q) av[q][i] = t[q];
      } else {
        ld4(a + (k + i) * as + ao[0], av[i]);
      }
    }
    SGT_UNROLL
    for (int j = 0; j < 4; ++j) {
      if (BK) {
        ld4(b + bo[j] + k, t);
        SGT_UNROLL
        for (int q = 0; q < 4; ++q) bv[q][j] = t[q];
      } else {
        ld4(b + (k + j) * bs + bo[0], bv[j]);
      }
    }
    SGT_UNROLL
    for (int q = 0; q < 4; ++q) {
      SGT_UNROLL
      for (int i = 0; i < 4; ++i) {
        SGT_UNROLL
        for (int j = 0; j < 4; ++j) c[i][j] = c[i][j] + av[q][i] * bv[q][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 tensor-core tile: mma.sync m16n8k16, bf16 operands, f32 sums
// ---------------------------------------------------------------------------

// Fragment maps of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (the
// PTX ISA's figures for .bf16 m16n8k16): lane l = 4 g + t of the warp holds
// A (16 x 16) elements a0..a7 at (mma_a_row, mma_a_col), B (16 x 8, k by n)
// elements b0..b3 at (mma_b_row, mma_b_col), and C (16 x 8) elements c0..c3
// at (mma_c_row, mma_c_col).  Register r of A holds a_2r (low half) and
// a_2r+1, which sit in one row at neighbouring k; B's likewise.
SGT_HD int mma_a_row(int lane, int i) { return (lane >> 2) + ((i >> 1) & 1) * 8; }
SGT_HD int mma_a_col(int lane, int i) { return (lane & 3) * 2 + (i & 1) + (i >> 2) * 8; }
SGT_HD int mma_b_row(int lane, int i) { return (lane & 3) * 2 + (i & 1) + (i >> 1) * 8; }
SGT_HD int mma_b_col(int lane, int) { return lane >> 2; }
SGT_HD int mma_c_row(int lane, int i) { return (lane >> 2) + (i >> 1) * 8; }
SGT_HD int mma_c_col(int lane, int i) { return (lane & 3) * 2 + (i & 1); }

// The lanes whose fragments one thread holds: on the card its own, in a
// host build (one thread) all 32 of the warp, lane lane0 + s in slot s.
#if defined(__CUDA_ARCH__)
constexpr int MMA_LANES = 1;
#else
constexpr int MMA_LANES = 32;
#endif

// lo and hi rounded to bfloat16 (round to nearest even) and packed, lo in
// the low half: cvt.rn.bf16x2.f32 on the card, bf16_round in a host build.
SGT_HD uint32_t pack_bf16x2(float lo, float hi) {
#if defined(__CUDA_ARCH__)
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
#else
  const float rl = bf16_round(lo), rh = bf16_round(hi);
  uint32_t l, h;
  std::memcpy(&l, &rl, sizeof l);
  std::memcpy(&h, &rh, sizeof h);
  return (l >> 16) | (h & 0xffff0000u);
#endif
}

#if !defined(__CUDA_ARCH__)
// Half k (0 low, 1 high) of a packed pair, as float (a host build's mma).
inline float bf16x2_half(uint32_t v, int k) {
  const uint32_t u = k ? (v & 0xffff0000u) : (v << 16);
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
#endif

// C += A B over one k16 step of one 16 x 8 tile, for the lanes a thread
// holds.  The card runs the mma instruction; a host build emulates the
// warp's: it places every lane's A and B elements by the fragment maps and
// adds to each C element its 16 exact products, summed in float32 in k
// order.
SGT_HD void mma_bf16(float (&c)[MMA_LANES][4], const uint32_t (&a)[MMA_LANES][4],
                     const uint32_t (&b)[MMA_LANES][2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(b[0][0]), "r"(b[0][1]));
#else
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 8; ++i)
      A[mma_a_row(l, i)][mma_a_col(l, i)] = bf16x2_half(a[l][i >> 1], i & 1);
    for (int i = 0; i < 4; ++i)
      B[mma_b_row(l, i)][mma_b_col(l, i)] = bf16x2_half(b[l][i >> 1], i & 1);
  }
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 4; ++i) {
      const int r = mma_c_row(l, i), n = mma_c_col(l, i);
      float s = 0.0f;
      for (int k = 0; k < 16; ++k) s = s + A[r][k] * B[k][n];
      c[l][i] = c[l][i] + s;
    }
  }
#endif
}

// Four floats rounded to bfloat16 at p (8-byte aligned), in order.
SGT_HD void st_bf16x4(uint16_t* p, const float (&v)[4]) {
  const uint32_t lo = pack_bf16x2(v[0], v[1]), hi = pack_bf16x2(v[2], v[3]);
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
#else
  std::memcpy(p, &lo, sizeof lo);
  std::memcpy(p + 2, &hi, sizeof hi);
#endif
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lane l gives the
// address of row l % 8 of 8 x 8 matrix l / 8 (8 bfloat16, 16-byte
// aligned); register i of lane t gets matrix i's row t / 4, columns 2 (t %
// 4) and 2 (t % 4) + 1, or with Trans its rows 2 (t % 4) and 2 (t % 4) + 1
// of column t / 4 (the lower column, or row, in the low half).  A host
// build gathers the same elements from the 32 lanes' row addresses.
template <bool Trans>
SGT_HD void ldmatrix_x4(uint32_t (&d)[MMA_LANES][4], const uint16_t* const (&row)[MMA_LANES]) {
#if defined(__CUDA_ARCH__)
  const unsigned a = (unsigned)__cvta_generic_to_shared(row[0]);
  if (Trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[0][0]), "=r"(d[0][1]), "=r"(d[0][2]), "=r"(d[0][3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[0][0]), "=r"(d[0][1]), "=r"(d[0][2]), "=r"(d[0][3]) : "r"(a));
#else
  for (int t = 0; t < 32; ++t) {
    for (int i = 0; i < 4; ++i) {
      const int c = 2 * (t & 3);
      const uint32_t lo = Trans ? row[8 * i + c][t >> 2] : row[8 * i + (t >> 2)][c];
      const uint32_t hi = Trans ? row[8 * i + c + 1][t >> 2] : row[8 * i + (t >> 2)][c + 1];
      d[t][i] = lo | (hi << 16);
    }
  }
#endif
}

// A bfloat16 product operand in shared memory, as its rows i (A's m, B's
// n) by the depth k: element (i, k) at p[i * s + k] (KC: each row runs
// along k, loaded by ldmatrix) or p[k * s + i] (by ldmatrix.trans); zero
// wherever a tile reaches past the product's extent.
struct MmaB16 {
  const uint16_t* p;
  int s;
};

// Lane lane's row address for A's 16 x 16 block (m0, k0): matrices a0a1,
// a2a3 (rows + 8), a4a5 (depth + 8), a6a7.
template <bool KC>
SGT_HD const uint16_t* ldm_a_row(const MmaB16& v, int m0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return KC ? v.p + (m0 + r + 8 * (mi & 1)) * v.s + k0 + 8 * (mi >> 1)
            : v.p + (k0 + r + 8 * (mi >> 1)) * v.s + m0 + 8 * (mi & 1);
}

// ... for B's two 8-column tiles n0 and n0 + 8 at depth k0: matrices b0b1,
// b2b3 (depth + 8) of tile n0, then of tile n0 + 8.
template <bool KC>
SGT_HD const uint16_t* ldm_b_row(const MmaB16& v, int n0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return KC ? v.p + (n0 + r + 8 * (mi >> 1)) * v.s + k0 + 8 * (mi & 1)
            : v.p + (k0 + r + 8 * (mi & 1)) * v.s + n0 + 8 * (mi >> 1);
}

// One warp's group of a product C = A B^T (A's rows m, B's rows n, both
// along the depth k): the 16-row tile m0 of A by MMA_NT 8-column tiles from
// n0, k from 0 to K (a multiple of 16) in order, added to c.  A k16 step
// loads its fragments with three ldmatrix.x4 while the step before runs
// its products.
constexpr int MMA_NT = 4;

SGT_HD void mma_zero(float (&c)[MMA_NT][MMA_LANES][4]) {
  SGT_UNROLL
  for (int j = 0; j < MMA_NT; ++j) {
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) {
      SGT_UNROLL
      for (int i = 0; i < 4; ++i) c[j][s][i] = 0.0f;
    }
  }
}

// A's and the group's B fragments of one k16 step
struct MmaFrags {
  uint32_t a[MMA_LANES][4];
  uint32_t b[MMA_NT][MMA_LANES][2];
};

template <bool AKC, bool BKC>
SGT_HD void mma_frags(MmaFrags& f, const MmaB16& A, const MmaB16& B, int m0, int n0, int k0,
                      int lane0) {
  const uint16_t* row[MMA_LANES];
  SGT_UNROLL
  for (int s = 0; s < MMA_LANES; ++s) row[s] = ldm_a_row<AKC>(A, m0, k0, lane0 + s);
  ldmatrix_x4<!AKC>(f.a, row);
  SGT_UNROLL
  for (int j = 0; j < MMA_NT; j += 2) {
    uint32_t d[MMA_LANES][4];
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) row[s] = ldm_b_row<BKC>(B, n0 + 8 * j, k0, lane0 + s);
    ldmatrix_x4<!BKC>(d, row);
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) {
      f.b[j][s][0] = d[s][0];
      f.b[j][s][1] = d[s][1];
      f.b[j + 1][s][0] = d[s][2];
      f.b[j + 1][s][1] = d[s][3];
    }
  }
}

template <bool AKC, bool BKC>
SGT_HD void mma_group(float (&c)[MMA_NT][MMA_LANES][4], const MmaB16& A, const MmaB16& B, int m0,
                      int n0, int K, int lane0) {
  MmaFrags f;
  mma_frags<AKC, BKC>(f, A, B, m0, n0, 0, lane0);
  for (int k0 = 0;; k0 += 16) {
    MmaFrags nxt;
    const bool more = k0 + 16 < K;
    if (more) mma_frags<AKC, BKC>(nxt, A, B, m0, n0, k0 + 16, lane0);
    SGT_UNROLL
    for (int j = 0; j < MMA_NT; ++j) mma_bf16(c[j], f.a, f.b[j]);
    if (!more) break;
    f = nxt;
  }
}

// The warps of a block: group q of a product (the 16-row tile of A q % M16,
// of M16, by B's 32 columns from 32 (q / M16)) runs on warp q % nwarps (a
// host build: one warp of all 32 lanes, every group in turn).
struct MmaWarp {
  int warp, nwarps, lane0;
};

SGT_HD MmaWarp mma_warp(int tid, int nthr) {
  return MmaWarp{tid >> 5, (nthr + 31) >> 5, MMA_LANES == 1 ? (tid & 31) : 0};
}

// v[slot] summed over the 4 lanes of its quad (lanes 4 g .. 4 g + 3), in
// the same order on every lane: (v + v^1) + (v^2 + v^3) by xor-butterfly.
SGT_HD void quad_sum(float (&v)[MMA_LANES]) {
#if defined(__CUDA_ARCH__)
  v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
  v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 2);
#else
  float w[MMA_LANES];
  for (int s = 0; s < MMA_LANES; ++s) w[s] = v[s] + v[s ^ 1];
  for (int s = 0; s < MMA_LANES; ++s) v[s] = w[s] + w[s ^ 2];
#endif
}

// Tile input i (< 11 R: feature i / R, row i % R) of the rows starting at
// column col: 0-6 obs, 7-8 raw and logp_old (rows 8, 9), 9-10 adv and ret;
// 0 past n_rows.  Consecutive i read consecutive columns.  The obs are
// only product operands: Bf16 rounds them here.
template <bool Bf16 = false>
SGT_HD float ppo_gather_load(const PPOArgs& a, int64_t col, int n_rows, int lr, int i) {
  const int f = i >> lr, r = i & ((1 << lr) - 1);
  if (r >= n_rows) return 0.0f;
  if (f < 7) return rnd<Bf16>(a.main[f * a.N + col + r]);
  if (f < 9) return a.main[(f + 1) * a.N + col + r];
  return a.advret[(f - 9) * a.N + col + r];
}

SGT_HD void ppo_gather_store(float* in, int RP, int lr, int i, float v) {
  const int f = i >> lr, r = i & ((1 << lr) - 1);
  in[f < 7 ? f * RP + r : 8 * RP + ((f - 7) << lr) + r] = v;
}

// Gathered values a thread holds in registers while the tile's dW1 runs
// (11 R of them over the block's threads; a host build stores the rest as
// it loads them).
constexpr int PPO_GATHER_REGS = 6;

// ppo_grad_block's products at bfloat16 on the tensor cores, over a tile
// of R rows in its bfloat16 layout (ppo_smem_bf16); each output element has
// one owning lane, each product runs its depth in order.  ACT: the trunk's
// activation, a template argument so that the epilogues do not branch.

// h2 = f(h1 W2 + b2) into m.h2 and the heads' partials: C [R, HB] = A B^T
// with A = h1 as rows r by depth k (h1b[k (R+8) + r]), B = W2 as rows n by
// depth k (w2b[k (HB+8) + n]).  A group's partial of mu (and of v) for row
// r, the rounded h2 times w_mu over its 32 features (each lane's two
// columns, then its quad), goes to hp[qn RP + r] (hp[(H4/4 + qn) RP + r]),
// qn the group's column block.
template <int ACT>
SGT_HD void mma_h2_heads(const PPOSmem& m, int H, int R, const MmaWarp& w) {
  const int RP = R + 4, H4 = ppo_h4(H), HB = ppo_hb(H), NP = H4 / 4, M16 = R / 16;
  const MmaB16 A{m.h1b, R + 8}, B{m.w2b, HB + 8};
  for (int q = w.warp; q < M16 * (HB / 32); q += w.nwarps) {
    const int m0 = 16 * (q % M16), qn = q / M16;
    float c[MMA_NT][MMA_LANES][4], pmu[2][MMA_LANES], pv[2][MMA_LANES];
    mma_zero(c);
    mma_group<false, false>(c, A, B, m0, 32 * qn, ppo_h16(H), w.lane0);
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) {
      const int lane = w.lane0 + s;
      pmu[0][s] = pmu[1][s] = pv[0][s] = pv[1][s] = 0.0f;
      SGT_UNROLL
      for (int j = 0; j < MMA_NT; ++j) {
        SGT_UNROLL
        for (int i = 0; i < 4; ++i) {
          // a column past H4 computes act(0) = 0 from W2's and b2's zero pad
          const int r = m0 + mma_c_row(lane, i), n = 32 * qn + 8 * j + mma_c_col(lane, i);
          const float h = act_f(ACT, c[j][s][i] + m.b2[n]), hr = bf16_round(h);
          if (n < H4) m.h2[n * RP + r] = h;
          pmu[i >> 1][s] = pmu[i >> 1][s] + hr * m.whm[n];
          pv[i >> 1][s] = pv[i >> 1][s] + hr * m.whv[n];
        }
      }
    }
    SGT_UNROLL
    for (int h = 0; h < 2; ++h) {
      quad_sum(pmu[h]);
      quad_sum(pv[h]);
    }
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) {
      const int lane = w.lane0 + s;
      if ((lane & 3) == 0) {
        SGT_UNROLL
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + (lane >> 2) + 8 * h;
          m.hp[qn * RP + r] = pmu[h][s];
          m.hp[(NP + qn) * RP + r] = pv[h][s];
        }
      }
    }
  }
}

// dW2's accumulator through a block's tiles: the groups of the product
// h1^T dg2 that a warp owns (group q on warp q % nwarps, in slot q /
// nwarps), in the mma fragments, from the block's first tile to its last.
// A warp of the card's 8 holds up to MMA_DW2_WARP_GROUPS groups (H <= 128;
// the launcher refuses more); a host build's one warp all 8 warps' groups.
constexpr int MMA_DW2_WARP_GROUPS = 4;
constexpr int MMA_DW2_GROUPS = MMA_LANES == 1 ? MMA_DW2_WARP_GROUPS : 8 * MMA_DW2_WARP_GROUPS;

template <bool On>
struct MmaDw2 {
  float c[MMA_DW2_GROUPS][MMA_NT][MMA_LANES][4];
};
template <>
struct MmaDw2<false> {};

SGT_HD void mma_dw2_zero(MmaDw2<true>& acc) {
  SGT_UNROLL
  for (int u = 0; u < MMA_DW2_GROUPS; ++u) mma_zero(acc.c[u]);
}

// dW2 += h1^T dg2 over the tile's R rows: A = h1 as rows k by depth r
// (h1b[k (R+8) + r]), B = dg2 as rows n by depth r (dgb).
SGT_HD void mma_dw2(MmaDw2<true>& acc, const PPOSmem& m, int H, int R, const MmaWarp& w) {
  const int M16 = ppo_h16(H) / 16;
  const MmaB16 h1{m.h1b, R + 8}, dg{m.dgb, R + 8};
  SGT_UNROLL
  for (int u = 0; u < MMA_DW2_GROUPS; ++u) {
    const int q = w.warp + u * w.nwarps;
    if (q < mma_dw2_groups(H))
      mma_group<true, true>(acc.c[u], h1, dg, 16 * (q % M16), 32 * (q / M16), R, w.lane0);
  }
}

// The accumulator into out [H, H] (the block's dW2 slot in device memory).
SGT_HD void mma_dw2_store(const MmaDw2<true>& acc, float* out, int H, const MmaWarp& w) {
  const int M16 = ppo_h16(H) / 16;
  SGT_UNROLL
  for (int u = 0; u < MMA_DW2_GROUPS; ++u) {
    const int q = w.warp + u * w.nwarps, m0 = 16 * (q % M16), n0 = 32 * (q / M16);
    if (q < mma_dw2_groups(H)) {
      SGT_UNROLL
      for (int s = 0; s < MMA_LANES; ++s) {
        const int lane = w.lane0 + s;
        SGT_UNROLL
        for (int j = 0; j < MMA_NT; ++j) {
          SGT_UNROLL
          for (int i = 0; i < 4; ++i) {
            const int k = m0 + mma_c_row(lane, i), n = n0 + 8 * j + mma_c_col(lane, i);
            if (k < H && n < H) out[k * H + n] = acc.c[u][j][s][i];
          }
        }
      }
    }
  }
}

// dg1 = (dg2 W2^T) f'(h1) into m.h2: A = dg2 as rows r by depth j
// (dgb[j (R+8) + r]), B = W2 as rows k by depth j (w2b[k (HB+8) + j]).
template <int ACT>
SGT_HD void mma_dg1(const PPOSmem& m, int H, int R, const MmaWarp& w) {
  const int RP = R + 4, H4 = ppo_h4(H), HB = ppo_hb(H), M16 = R / 16;
  const MmaB16 dg{m.dgb, R + 8}, w2{m.w2b, HB + 8};
  for (int q = w.warp; q < M16 * (HB / 32); q += w.nwarps) {
    const int m0 = 16 * (q % M16), n0 = 32 * (q / M16);
    float c[MMA_NT][MMA_LANES][4];
    mma_zero(c);
    mma_group<false, true>(c, dg, w2, m0, n0, ppo_h16(H), w.lane0);
    SGT_UNROLL
    for (int s = 0; s < MMA_LANES; ++s) {
      const int lane = w.lane0 + s;
      SGT_UNROLL
      for (int j = 0; j < MMA_NT; ++j) {
        SGT_UNROLL
        for (int i = 0; i < 4; ++i) {
          // a column past H4 (zero) reads a row of h1 that exists and stores nothing
          const int r = m0 + mma_c_row(lane, i), k = n0 + 8 * j + mma_c_col(lane, i);
          const float g = c[j][s][i] * act_grad(ACT, m.h1[(k < H4 ? k : H4 - 1) * RP + r]);
          if (k < H4) m.h2[k * RP + r] = g;
        }
      }
    }
  }
}

// Forward, loss and hand-derived backward over part cta % a.split of the bs
// rows of shuffle block a.perm[cta / a.split] (a contiguous run of rows), in
// tiles of ppo_tile_rows(H) rows; its gradient and loss sums go to
// a.partial[cta].  At float32 every product runs on 4 x 4 register
// micro-tiles (micro_product); the short sums over rows run in splits of
// PPO_SPLIT_ROWS rows, each into its own accumulator copy.  Each
// accumulator has one owning thread and every sum runs in a fixed order, so
// a step is deterministic.  Six barriers per tile.  Coherent: the weights
// and scalars come from K5's previous optimizer phase.
//
// Bf16: the bfloat16 compute dtype, in its own shared-memory layout
// (ppo_smem_bf16).  The three H x H products (h1 W2, h1^T dg2, dg2 W2^T)
// run on the tensor cores (mma_h2_heads, mma_dw2, mma_dg1: bf16 mma.sync
// tiles with float32 sums, each warp its fixed groups of tiles, the depth
// in order; dW2 summed in the warps' fragments through the block's tiles
// and stored once); x W1 (depth 8), the heads and dW1 (7 rows) stay on the
// micro-tiles.  The weights and the obs are only product operands, so they
// are rounded as they are loaded into shared memory (W2 as bfloat16), and
// so is dg2 as it is stored as bfloat16 (its bias sum db2 is taken first);
// h1 and h2 stay float32 for the derivatives, so h1 is also stored rounded
// as bfloat16 for the products, and h2, dmu, dv and dg1 are rounded where
// the short sums read them (db_head and db1 sum the unrounded values).
template <bool Coherent = false, bool Bf16 = false>
SGT_HD void ppo_grad_block(const PPOArgs& a, int cta, float* smem, int tid, int nthr) {
  constexpr int SR = PPO_SPLIT_ROWS, GR = PPO_GATHER_REGS;
  const int H = a.H, act = a.act, R = Bf16 ? ppo_tile_rows_bf16(H) : ppo_tile_rows(H);
  const int RP = R + 4, H4 = ppo_h4(H);
  const int HS = ppo_wstride(H), NP = H4 / 4, MT = R / 4;
  const int lr = R == 128 ? 7 : (R == 64 ? 6 : 5);
  const int L = ppo_out_len(H), SL = ppo_small_len(H);
  const int NSPLIT = Bf16 ? R / PPO_SPLIT_ROWS : ppo_row_splits(H);
  // the heads' partials per row: one per 4 features, or per mma group of 32
  const int NQ = Bf16 ? (H + 31) / 32 : NP;
  const PPOSmem m = ppo_smem_for<Bf16>(smem, H);
  const float log_std = ld<Coherent>(a.scal), adv_mean = ld<Coherent>(a.scal + 1);
  const float adv_rstd = ld<Coherent>(a.scal + 2), inv_n = ld<Coherent>(a.scal + 3);
  const float es = expf(-log_std);
  MmaDw2<Bf16> dw2acc;  // Bf16: dW2's accumulator in the warps' fragments
  if constexpr (Bf16) mma_dw2_zero(dw2acc);

  for (int i = tid; i < 8 * HS; i += nthr) {
    const int k = i / HS, j = i % HS;
    m.w1[i] = (k < 7 && j < H) ? rnd<Bf16>(ld<Coherent>(a.w1 + k * H + j)) : 0.0f;
  }
  if constexpr (Bf16) {
    // W2 as bfloat16 pairs, zero past H; h1's and dg2's rows past H4 zero
    const int HB = ppo_hb(H), WB = HB + 8, RB = R + 8;
    for (int i = tid; i < HB * WB / 2; i += nthr) {
      const int k = i / (WB / 2), j = 2 * (i % (WB / 2));
      const float lo = (k < H && j < H) ? ld<Coherent>(a.w2 + k * H + j) : 0.0f;
      const float hi = (k < H && j + 1 < H) ? ld<Coherent>(a.w2 + k * H + j + 1) : 0.0f;
      reinterpret_cast<uint32_t*>(m.w2b)[i] = pack_bf16x2(lo, hi);
    }
    for (int i = tid; i < (HB - H4) * RB / 2; i += nthr) {
      reinterpret_cast<uint32_t*>(m.h1b + H4 * RB)[i] = 0u;
      reinterpret_cast<uint32_t*>(m.dgb + H4 * RB)[i] = 0u;
    }
  } else {
    for (int i = tid; i < H4 * HS; i += nthr) {
      const int k = i / HS, j = i % HS;
      m.w2[i] = (k < H && j < H) ? ld<Coherent>(a.w2 + k * H + j) : 0.0f;
    }
  }
  for (int j = tid; j < (Bf16 ? ppo_hb(H) : H4); j += nthr) {
    const bool in = j < H;
    m.b1[j] = in ? ld<Coherent>(a.b1 + j) : 0.0f;
    m.b2[j] = in ? ld<Coherent>(a.b2 + j) : 0.0f;
    m.whm[j] = in ? rnd<Bf16>(ld<Coherent>(a.wh + 2 * j)) : 0.0f;
    m.whv[j] = in ? rnd<Bf16>(ld<Coherent>(a.wh + 2 * j + 1)) : 0.0f;
  }
  for (int i = tid; i < 4; i += nthr) m.bh[i] = i < 2 ? ld<Coherent>(a.bh + i) : 0.0f;
  for (int i = tid; i < 2 * (8 * RP + 4 * R); i += nthr) m.in0[i] = 0.0f;  // x^T row 7
  if constexpr (!Bf16)
    for (int i = tid; i < H * H; i += nthr) m.dw2[i] = 0.0f;
  for (int i = tid; i < NSPLIT * SL; i += nthr) m.split[i] = 0.0f;
  SGT_SYNC();
  const int part = cta % a.split;
  const int lo = (int)((int64_t)part * a.bs / a.split);
  const int nb = (int)((int64_t)(part + 1) * a.bs / a.split) - lo;  // this block's rows
  const int64_t col0 = a.perm[cta / a.split] * (int64_t)a.bs + lo;
  for (int i = tid; i < 11 * R; i += nthr)
    ppo_gather_store(m.in0, RP, lr, i, ppo_gather_load<Bf16>(a, col0, nb < R ? nb : R, lr, i));
  SGT_SYNC();

  int cur = 0;
  for (int r0 = 0; r0 < nb; r0 += R, cur ^= 1) {
    const int n_rows = nb - r0 < R ? nb - r0 : R;
    float* const x = cur ? m.in1 : m.in0;  // x^T [8, RP]
    float* const nxt = cur ? m.in0 : m.in1;
    const float* raw = x + 8 * RP;
    const float *lpo = raw + R, *adv = lpo + R, *ret = adv + R;
    // ---- h1 = f(x W1 + b1): tiles of 4 consecutive rows x 4 consecutive features ----
    // (Bf16: rows run fastest over the threads, so that a warp's 8-byte
    // stores of the bfloat16 h1 rows land in distinct banks)
    for (int t = tid; t < MT * NP; t += nthr) {
      const int r = 4 * (Bf16 ? t % MT : t / NP), n = 4 * (Bf16 ? t / MT : t % NP);
      const int ao[4] = {r, 0, 0, 0}, bo[4] = {n, 0, 0, 0};
      float c[4][4];
      micro_product<false, false>(c, x, RP, ao, m.w1, HS, bo, 8);
      SGT_UNROLL
      for (int j = 0; j < 4; ++j) {
        float h[4];
        SGT_UNROLL
        for (int i = 0; i < 4; ++i) h[i] = act_f(act, c[i][j] + m.b1[n + j]);
        st4(m.h1 + (n + j) * RP + r, h);
        if constexpr (Bf16) st_bf16x4(m.h1b + (n + j) * (R + 8) + r, h);
      }
    }
    SGT_SYNC();
    // ---- h2 = f(h1 W2 + b2), and each tile's part of the heads ----
    if constexpr (Bf16) {
      if (act == ACT_RELU)
        mma_h2_heads<ACT_RELU>(m, H, R, mma_warp(tid, nthr));
      else
        mma_h2_heads<ACT_TANH>(m, H, R, mma_warp(tid, nthr));
    } else {
      for (int t = tid; t < MT * NP; t += nthr) {
        const int q = t % NP, r = 4 * (t / NP), n = 4 * q;
        const int ao[4] = {r, 0, 0, 0}, bo[4] = {n, 0, 0, 0};
        float c[4][4], pmu[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        micro_product<false, false>(c, m.h1, RP, ao, m.w2, HS, bo, H4);
        SGT_UNROLL
        for (int j = 0; j < 4; ++j) {
          const float b = m.b2[n + j], w_mu = m.whm[n + j], w_v = m.whv[n + j];
          float h[4];
          SGT_UNROLL
          for (int i = 0; i < 4; ++i) {
            h[i] = act_f(act, c[i][j] + b);
            pmu[i] = pmu[i] + h[i] * w_mu;
            pv[i] = pv[i] + h[i] * w_v;
          }
          st4(m.h2 + (n + j) * RP + r, h);
        }
        st4(m.hp + q * RP + r, pmu);
        st4(m.hp + (NP + q) * RP + r, pv);
      }
    }
    SGT_SYNC();
    // ---- heads (the partials summed in feature order) and the per-row loss ----
    for (int r = tid; r < R; r += nthr) {
      float dmu = 0.0f, dv = 0.0f, rows[3] = {0.0f, 0.0f, 0.0f};
      if (r < n_rows) {
        float mu = 0.0f, v = 0.0f;
        for (int q = 0; q < NQ; ++q) {
          mu = mu + m.hp[q * RP + r];
          v = v + m.hp[(NP + q) * RP + r];
        }
        ppo_row(raw[r], lpo[r], adv[r], ret[r], mu + m.bh[0], v + m.bh[1], log_std, es,
                adv_mean, adv_rstd, inv_n, a.clip_lo, a.clip_hi, a.vf_coef, dmu, dv, rows);
      }
      m.dmu[r] = dmu;
      m.dv[r] = dv;
      SGT_UNROLL
      for (int k = 0; k < 3; ++k) m.rows[k * R + r] = rows[k];
    }
    SGT_SYNC();
    // ---- dg2 = (dmu, dv) W_head^T f'(h2), dW_head, db2: one item per (split, feature) ----
    for (int i = tid; i < NSPLIT * H4; i += nthr) {
      const int s = i / H4, j = i % H4, rs = s * SR;
      const float w_mu = m.whm[j], w_v = m.whv[j];
      float sm = 0.0f, sv = 0.0f, sg = 0.0f;
      for (int r = rs; r < rs + SR; r += 4) {
        float h[4], dm[4], dvv[4], g[4];
        ld4(m.h2 + j * RP + r, h);
        ld4(m.dmu + r, dm);
        ld4(m.dv + r, dvv);
        SGT_UNROLL
        for (int k = 0; k < 4; ++k) {
          const float hk = rnd<Bf16>(h[k]), dmk = rnd<Bf16>(dm[k]), dvk = rnd<Bf16>(dvv[k]);
          const float gk = (dmk * w_mu + dvk * w_v) * act_grad(act, h[k]);
          sm = sm + hk * dmk;
          sv = sv + hk * dvk;
          sg = sg + gk;
          g[k] = gk;
        }
        if constexpr (Bf16)
          st_bf16x4(m.dgb + j * (R + 8) + r, g);
        else
          st4(m.dg + j * RP + r, g);
      }
      if (j < H) {
        float* sp = m.split + s * SL;
        sp[8 * H + j] += sg;
        sp[9 * H + 2 * j] += sm;
        sp[9 * H + 2 * j + 1] += sv;
      }
    }
    // db_head and the three loss sums, one item per (split, sum)
    for (int i = tid; i < NSPLIT * 5; i += nthr) {
      const int s = i / 5, q = i % 5, rs = s * SR;
      const float* d = q == 0 ? m.dmu : (q == 1 ? m.dv : m.rows + (q - 2) * R);
      float acc = 0.0f;
      for (int r = rs; r < rs + SR; ++r) acc = acc + d[r];
      m.split[s * SL + 11 * H + q] += acc;
    }
    SGT_SYNC();
    // ---- dW2 += h1^T dg2 (both along rows); dg1 = (dg2 W2^T) f'(h1) into h2 ----
    if constexpr (Bf16) {
      mma_dw2(dw2acc, m, H, R, mma_warp(tid, nthr));
      if (act == ACT_RELU)
        mma_dg1<ACT_RELU>(m, H, R, mma_warp(tid, nthr));
      else
        mma_dg1<ACT_TANH>(m, H, R, mma_warp(tid, nthr));
    } else {
      for (int t = tid; t < NP * NP; t += nthr) {
        const int tm = t / NP, tn = t % NP;
        int ao[4], bo[4];
        SGT_UNROLL
        for (int i = 0; i < 4; ++i) {
          ao[i] = (tm + i * NP) * RP;
          bo[i] = (tn + i * NP) * RP;
        }
        float c[4][4];
        micro_product<true, true>(c, m.h1, RP, ao, m.dg, RP, bo, R);
        SGT_UNROLL
        for (int i = 0; i < 4; ++i) {
          const int k = tm + i * NP;
          SGT_UNROLL
          for (int j = 0; j < 4; ++j) {
            const int n = tn + j * NP;
            if (k < H && n < H) m.dw2[k * H + n] += c[i][j];
          }
        }
      }
      for (int t = tid; t < MT * NP; t += nthr) {
        const int r = 4 * (t / NP), tn = t % NP;
        int ao[4] = {r, 0, 0, 0}, bo[4];
        SGT_UNROLL
        for (int j = 0; j < 4; ++j) bo[j] = (tn + j * NP) * HS;
        float c[4][4];
        micro_product<false, true>(c, m.dg, RP, ao, m.w2, HS, bo, H4);
        SGT_UNROLL
        for (int j = 0; j < 4; ++j) {
          const int o = (tn + j * NP) * RP + r;
          float h[4], g[4];
          ld4(m.h1 + o, h);
          SGT_UNROLL
          for (int i = 0; i < 4; ++i) g[i] = c[i][j] * act_grad(act, h[i]);
          st4(m.h2 + o, g);
        }
      }
    }
    SGT_SYNC();
    // ---- the next tile's inputs loaded; dW1 += x^T dg1, db1 by (split, feature); stored ----
    const bool more = r0 + R < nb;
    const int64_t col_n = col0 + r0 + R;
    const int rows_n = nb - r0 - R < R ? nb - r0 - R : R;
    float gv[GR];
    SGT_UNROLL
    for (int k = 0; k < GR; ++k) {
      const int i = tid + k * nthr;
      gv[k] = (more && i < 11 * R) ? ppo_gather_load<Bf16>(a, col_n, rows_n, lr, i) : 0.0f;
    }
    for (int i = tid; i < NSPLIT * H4; i += nthr) {
      const int s = i / H4, j = i % H4, rs = s * SR;
      float dw[7], db = 0.0f;
      SGT_UNROLL
      for (int f = 0; f < 7; ++f) dw[f] = 0.0f;
      for (int r = rs; r < rs + SR; r += 4) {
        float g[4], xv[4];
        ld4(m.h2 + j * RP + r, g);
        float gr[4];
        SGT_UNROLL
        for (int k = 0; k < 4; ++k) gr[k] = rnd<Bf16>(g[k]);
        SGT_UNROLL
        for (int f = 0; f < 7; ++f) {
          ld4(x + f * RP + r, xv);
          SGT_UNROLL
          for (int k = 0; k < 4; ++k) dw[f] = dw[f] + xv[k] * gr[k];
        }
        SGT_UNROLL
        for (int k = 0; k < 4; ++k) db = db + g[k];
      }
      if (j < H) {
        float* sp = m.split + s * SL;
        SGT_UNROLL
        for (int f = 0; f < 7; ++f) sp[f * H + j] += dw[f];
        sp[7 * H + j] += db;
      }
    }
    if (more) {
      SGT_UNROLL
      for (int k = 0; k < GR; ++k) {
        const int i = tid + k * nthr;
        if (i < 11 * R) ppo_gather_store(nxt, RP, lr, i, gv[k]);
      }
      for (int i = tid + GR * nthr; i < 11 * R; i += nthr)
        ppo_gather_store(nxt, RP, lr, i, ppo_gather_load<Bf16>(a, col_n, rows_n, lr, i));
    }
    SGT_SYNC();
  }
  // ---- the block's output: dW2 as accumulated, the rest folded in split order ----
  float* out = a.partial + (size_t)cta * L;
  const int d0 = 8 * H, d1 = 8 * H + H * H;
  if constexpr (Bf16) {
    mma_dw2_store(dw2acc, out + d0, H, mma_warp(tid, nthr));
    for (int q = tid; q < L - H * H; q += nthr) {
      float s = 0.0f;
      for (int k = 0; k < NSPLIT; ++k) s += m.split[k * SL + q];
      out[q < d0 ? q : q + H * H] = s;
    }
    return;
  }
  for (int i = tid; i < L; i += nthr) {
    float s = 0.0f;
    if (i >= d0 && i < d1) {
      s = m.dw2[i - d0];
    } else {
      const int q = i < d0 ? i : i - H * H;
      for (int k = 0; k < NSPLIT; ++k) s += m.split[k * SL + q];
    }
    out[i] = s;
  }
}

// K4's arguments: the same routine over the 12-row buffer [12, N] (0-6 obs,
// 7 zero, 8 raw, 9 logp_old, 10 adv, 11 ret) in a.main, whose rows 0-9 have
// K3's layout; the adv/ret rows are read at row 10 of the same buffer.
SGT_HD PPOArgs ppo_grad12_args(PPOArgs a) {
  a.advret = a.main + 10 * a.N;
  return a;
}

// Entry i of the step's output: the CUDA blocks' partials [n_cta, L] summed
// in block order.
SGT_HD float block_sum(const float* partial, int n_cta, int L, int i) {
  float s = 0.0f;
  for (int k = 0; k < n_cta; ++k) s += ld_cg(partial + (size_t)k * L + i);
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
  float* norm_part;      // [grid] scratch: each CUDA block's sum of squares
  float* aux;            // [n_mb, 4]: pg mean, v mean, entropy, |g|
  int n_mb, nblk;        // minibatches; shuffle blocks per minibatch
  int grid;              // CUDA blocks of the launch, 1..epoch_items (the launcher
                         // lowers it to what the card holds at once)
  float b1, omb1, b2, omb2, eps, neg_lr, max_norm, ent_coef, n_rows, ent_const;
};

// A minibatch's grad-step work items: g.split per shuffle block, each with
// its own partial.  The grid's blocks walk them in steps of e.grid.
SGT_HD int epoch_items(const EpochArgs& e) { return e.nblk * e.g.split; }

// Minibatch k's grad-step arguments (phase 1): its shuffle blocks and its
// row of stats.
SGT_HD PPOArgs epoch_step_args(const EpochArgs& e, int k) {
  PPOArgs a = ppo_grad12_args(e.g);
  a.perm = e.perm + (size_t)k * e.nblk;
  a.scal = e.stats + 8 * (size_t)k;
  return a;
}

// Phase 1 of minibatch k, block blk of e.grid: work items blk, blk + grid,
// ... of its grad step, each into its own partial, at the compute dtype
// Bf16 (the launcher's instantiation for e.g.bf16).
template <bool Bf16 = false>
SGT_HD void epoch_grad(const EpochArgs& e, int k, int blk, float* smem, int tid, int nthr) {
  const PPOArgs a = epoch_step_args(e, k);
  for (int item = blk; item < epoch_items(e); item += e.grid) {
    ppo_grad_block<true, Bf16>(a, item, smem, tid, nthr);
    SGT_SYNC();  // the next item's set-up overwrites what this one's output reads
  }
}

// Block blk's contiguous slice [lo, hi) of the P parameters, of n_blk.
SGT_HD void epoch_slice(int P, int n_blk, int blk, int& lo, int& hi) {
  const int per = (P + n_blk - 1) / n_blk;
  lo = blk * per < P ? blk * per : P;
  hi = lo + per < P ? lo + per : P;
}

// Phase 2 of a minibatch, block blk of e.grid: its slice of the gradient
// (every work item's partial summed in item order, the entropy term folded
// into log_std) into e.grad, and the slice's sum of squares into
// norm_part[blk].
SGT_HD void epoch_reduce(const EpochArgs& e, int blk, int tid, int nthr) {
  const int H = e.g.H, L = ppo_out_len(H), ls = ppo_log_std_index(H);
  int lo, hi;
  epoch_slice(ppo_n_params(H), e.grid, blk, lo, hi);
  for (int i = lo + tid; i < hi; i += nthr) {
    const float s = block_sum(e.g.partial, epoch_items(e), L, flat_to_out(H, i));
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
  for (int b = 0; b < e.grid; ++b) sq += ld_cg(e.norm_part + b);
  const float gn = sqrtf(sq);
  const bool clipped = !(gn < e.max_norm);
  const float* st = e.stats + 8 * (size_t)k;
  const float c1 = st[4], c2 = st[5];
  int lo, hi;
  epoch_slice(ppo_n_params(H), e.grid, blk, lo, hi);
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
    row[0] = block_sum(e.g.partial, epoch_items(e), L, L - 2) / e.n_rows;
    row[1] = block_sum(e.g.partial, epoch_items(e), L, L - 1) / e.n_rows;
    row[2] = ld_cg(st) + e.ent_const;
    row[3] = gn;
  }
}

}  // namespace sgt
