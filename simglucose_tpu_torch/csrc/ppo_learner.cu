// K2 (GAE), K3 and K4 (the fused PPO grad step) and K5 (the whole PPO
// learner) as CUDA kernels for Hopper (sm_90a), built into the same library
// as the rollout kernels.
//
// K2 replaces simglucose_tpu/ops/pallas_ppo_learner.py::_gae_kernel (via
// gae_pack).  It moves 20 bytes per lane-step (10.5 MB at B=8192, T=64:
// 3.1 us at 3.35 TB/s) against ~9 FLOP, so bytes bound it, but only 8192
// lanes walk T dependent steps: 256 warps, two per SM, whose loads no
// occupancy can hide.  So each block is one warp that owns 32 consecutive
// lanes and keeps every load in flight at once: time goes in chunks of
// GAE_ROWS rows (ppo_math.cuh), walked from the last to the first, and a
// chunk's [GAE_ROWS, 32] tiles of reward, done and value are staged in
// shared memory by cp.async (16-byte copies where B is a multiple of 4 and
// the rows 16-byte aligned, else 4-byte ones), double-buffered: the first
// two chunks (all of T = 64) are issued before the walk starts, and chunk
// k + 2 is issued as soon as chunk k is walked.  The recurrence reads
// shared memory (gae_rows, the JAX kernel's order), and a warp stores each
// time row's advantages and returns as two 128-byte rows.  One warp a
// block, B/32 blocks (256 at B=8192: every SM has one or two), 24 KB of
// shared memory a block: neither shared memory nor registers limit it;
// what is left is the latency of the first chunk's loads and of the walk.
//
// K3 replaces ::_kernel2 (via ppo_grad_step_gather2): forward, clipped
// surrogate and value loss, and the hand-derived backward over one
// minibatch gathered by shuffle-block ids.  PPOArgs.split CUDA blocks per
// shuffle block (2 at the bench shape: 64 blocks of a minibatch on 132 SMs,
// see ops/ppo_learner.py::_grad_split) each take a contiguous part of its
// rows, reading the block's id from perm (the TPU kernel's scalar
// prefetch); the weights, a tile of R rows (R x H = 4096: 64 rows at H =
// 64, 32 at H = 128) and its activations (h1, h2, dg2, feature-major) sit
// in shared memory, and each CUDA block's gradient and loss sums are
// written to its own slot of a scratch buffer, which a second kernel sums
// over the blocks in a fixed order (no atomics: a step is deterministic).
// A grad step is ~27 KFLOP per row of f32 FMAs on CUDA cores (3.6 GFLOP at
// 131072 rows).  At float32 every product runs on 4 x 4 register
// micro-tiles with 16-byte shared-memory loads, 8 loads per 64 FMAs; a
// 16-byte load costs a warp 4 shared-memory cycles, so the products are
// bound by shared-memory bandwidth at 64 FMAs per clock per SM, half the
// FMA pipes' rate (the bfloat16 instantiation: below).
//
// K4 replaces ::_kernel (via ppo_grad_step and ppo_grad_step_gather): the
// same grad step over the 12-row buffer [12, N] (0-6 obs, 7 zero, 8 raw, 9
// logp_old, 10 adv, 11 ret).  Rows 0-9 have K3's layout, so K4 is K3's
// kernel with the adv/ret rows read at row 10 of the same buffer, and 1/n
// taken from the caller's loss_rows.
//
// K5 replaces ::_epoch_kernel (via ppo_epoch_update): every epoch x
// minibatch grad step, the global-norm clip and Adam in one launch.  The
// TPU kernel walks its grid in order on one core with the weights in VMEM;
// here a minibatch's grad step runs across the card, so the minibatch
// boundary is a grid-wide barrier.  One cooperative launch of as many
// blocks as the card holds at once (at most the bpm x split work items; 128
// at the bench shape) runs, per minibatch, K4's block routine over the work
// items (block b takes items b, b + grid, ..., each its part of a shuffle
// block into its own partial), grid.sync(), each block's slice of the
// parameters summing the items' partials in item order, grid.sync(), the
// norm (every block sums the slices' parts in the same order) and Adam on
// each slice in global memory, grid.sync().  So any bpm runs.  No atomics:
// two runs on one card are bit-identical (the norm's order follows the
// grid).  Its work is 8 x K4's (0.43 ms of f32 FMAs at 67 TFLOP/s at the
// bench shape); it is bound as K4 is, plus 24 barriers.  A float32 block
// takes 214 KB of shared memory at H = 128 (the opt-in above 48 KB), 114 KB
// at H = 64, and 150 registers per thread: one block per SM (bfloat16: 255
// registers, one block per SM too).
//
// compute_dtype: ppo_grad_kernel (K3 and K4) and ppo_epoch_kernel (K5) are
// each instantiated twice, float32 and bfloat16, as the JAX kernels take
// compute_dtype=bfloat16 under PPOConfig.learner_bf16; the launchers pick
// one by PPOArgs.bf16.  The bfloat16 instantiation runs the step's three
// H x H products (91% of its multiply-adds at H = 64) on the tensor cores,
// as the TPU kernel ran them on its MXU: mma.sync m16n8k16 tiles of
// bfloat16 operands with float32 sums, each of the block's 8 warps on its
// fixed groups of four 16 x 8 tiles, the depth in order, so a step stays
// deterministic (ppo_math.cuh::mma_group).  W2, h1 and dg2 sit in shared
// memory as bfloat16 (rounded to nearest even as they are stored), each
// row padded so that a k16 step loads a warp's fragments with three
// ldmatrix.x4 and no bank conflict; dW2 sums in the warps' fragments
// through a block's tiles (up to 64 registers a thread at H = 128).  Its
// layout (ppo_smem_bf16) drops the float32 W2, dg2 and dW2, which leaves
// room for 64-row tiles at H = 128 (93 KB at H = 64, 195 KB at H = 128).
// The products are bound by the warps' latency (8 warps an SM, one block
// of 255 registers a thread), not by the tensor cores' rate; the rest of
// the step (x W1, the row loss, the short sums, dW1, the gather and six
// barriers a tile) is the float32 instantiation's code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ppo_math.cuh"

namespace {

constexpr int kGaeThreads = sgt::GAE_LANES;  // one warp a block
constexpr int kGaeStages = 2;
constexpr int kGradThreads = 256;
constexpr int kReduceThreads = 256;

// A chunk of K2's inputs in shared memory: [row][lane] of each.
struct GaeTile {
  float r[sgt::GAE_ROWS][sgt::GAE_LANES];
  float d[sgt::GAE_ROWS][sgt::GAE_LANES];
  float v[sgt::GAE_ROWS][sgt::GAE_LANES];
};

// cp.async of Bytes (4 or 16) from global to shared memory, of which the
// first src bytes are read and the rest zero-filled
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
}

// Issue the copies of rows [t0, t0 + n) x lanes [b0, b0 + 32) of the three
// inputs into a tile (lanes past B zero-filled), then commit them as one
// group; k past the last chunk commits an empty group, so that a wait for
// all but the newest group always means chunk k - 1 has landed.
template <bool Vec>
__device__ __forceinline__ void gae_stage(GaeTile& tile, int T, int k, int B, int b0,
                                          const float* reward, const float* done,
                                          const float* value) {
  if (k < sgt::gae_chunks(T)) {
    int t0, n;
    sgt::gae_chunk(T, k, t0, n);
    constexpr int W = Vec ? 4 : 1;  // floats a copy
    constexpr int per_row = sgt::GAE_LANES / W;
    for (int e = threadIdx.x; e < n * per_row; e += kGaeThreads) {
      const int row = e / per_row, col = (e % per_row) * W;
      const int b = b0 + col;
      const int bytes = b < B ? 4 * W : 0;  // B % W == 0: a copy is all in or all out
      const size_t o = bytes ? (size_t)(t0 + row) * B + b : 0;
      cp_async<4 * W>(&tile.r[row][col], reward + o, bytes);
      cp_async<4 * W>(&tile.d[row][col], done + o, bytes);
      cp_async<4 * W>(&tile.v[row][col], value + o, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool Vec>
__global__ void __launch_bounds__(kGaeThreads)
    gae_kernel(int T, int B, const float* __restrict__ reward,
               const float* __restrict__ done, const float* __restrict__ value,
               const float* __restrict__ tail, float gamma, float gl,
               float* __restrict__ out) {
  __shared__ __align__(16) GaeTile tile[kGaeStages];
  const int lane = threadIdx.x, b0 = blockIdx.x * sgt::GAE_LANES;
  const size_t b = (size_t)b0 + lane;
  const bool mine = b < (size_t)B;
  for (int k = 0; k < kGaeStages; ++k) gae_stage<Vec>(tile[k], T, k, B, b0, reward, done, value);
  sgt::GaeCarry carry{0.0f, mine ? tail[b] : 0.0f};
  const size_t TB = (size_t)T * B;
  const int n_chunks = sgt::gae_chunks(T);
  for (int k = 0; k < n_chunks; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGaeStages - 1));
    __syncthreads();
    GaeTile& s = tile[k % kGaeStages];
    if (mine) {
      int t0, n;
      sgt::gae_chunk(T, k, t0, n);
      float* adv = out + (size_t)t0 * B + b;
      sgt::gae_rows(n, &s.r[0][lane], &s.d[0][lane], &s.v[0][lane], sgt::GAE_LANES, adv,
                    adv + TB, (size_t)B, gamma, gl, carry);
    }
    __syncthreads();  // every lane has read the stage before it is refilled
    gae_stage<Vec>(s, T, k + kGaeStages, B, b0, reward, done, value);
  }
}

// dynamic shared memory as float4: the block routine's 16-byte loads
extern __shared__ float4 smem4[];

template <bool Bf16>
__global__ void __launch_bounds__(kGradThreads) ppo_grad_kernel(const sgt::PPOArgs a) {
  float* smem = reinterpret_cast<float*>(smem4);
  sgt::ppo_grad_block<false, Bf16>(a, blockIdx.x, smem, threadIdx.x, blockDim.x);
}

template <bool Bf16>
__global__ void __launch_bounds__(kGradThreads) ppo_epoch_kernel(const sgt::EpochArgs e) {
  float* smem = reinterpret_cast<float*>(smem4);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < e.n_mb; ++k) {
    sgt::epoch_grad<Bf16>(e, k, blockIdx.x, smem, threadIdx.x, blockDim.x);
    grid.sync();
    sgt::epoch_reduce(e, blockIdx.x, threadIdx.x, blockDim.x);
    grid.sync();
    sgt::epoch_adam(e, k, blockIdx.x, threadIdx.x, blockDim.x);
    grid.sync();
  }
}

// out[i] = sum over blocks of partial[blk, i], blocks in order
__global__ void __launch_bounds__(kReduceThreads)
    block_sum_kernel(const float* __restrict__ partial, int n_cta, int L,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  out[i] = sgt::block_sum(partial, n_cta, L, i);
}

cudaError_t opt_in_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// bf16: dW2's tensor-core groups must fit the warps' accumulators
bool bf16_fits(const sgt::PPOArgs& a) {
  return !a.bf16 || sgt::mma_dw2_groups(a.H) <= sgt::MMA_DW2_WARP_GROUPS * (kGradThreads / 32);
}

int launch_grad(const sgt::PPOArgs& a, int n_blk, void* out, void* stream) {
  if (n_blk <= 0 || a.H <= 0 || a.bs <= 0 || (a.bf16 != 0 && a.bf16 != 1) || !bf16_fits(a))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sgt::ppo_smem_bytes(a.H, a.bf16);
  const void* kernel =
      a.bf16 ? (const void*)ppo_grad_kernel<true> : (const void*)ppo_grad_kernel<false>;
  cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.split <= 0) return (int)cudaErrorInvalidValue;
  const int n_cta = n_blk * a.split;
  if (a.bf16)
    ppo_grad_kernel<true><<<n_cta, kGradThreads, smem, s>>>(a);
  else
    ppo_grad_kernel<false><<<n_cta, kGradThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int L = sgt::ppo_out_len(a.H);
  block_sum_kernel<<<(L + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      a.partial, n_cta, L, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// reward/done/value [T, B], tail [B], out [2, T*B]; device pointers
int sgt_gae_launch(int T, int B, const void* reward, const void* done, const void* value,
                   const void* tail, float gamma, float gl, void* out, void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = B % 4 == 0 && aligned(reward) && aligned(done) && aligned(value);
  const int blocks = (B + sgt::GAE_LANES - 1) / sgt::GAE_LANES;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *r = static_cast<const float*>(reward), *d = static_cast<const float*>(done),
              *v = static_cast<const float*>(value), *tl = static_cast<const float*>(tail);
  if (vec)
    gae_kernel<true><<<blocks, kGaeThreads, 0, s>>>(T, B, r, d, v, tl, gamma, gl,
                                                    static_cast<float*>(out));
  else
    gae_kernel<false><<<blocks, kGaeThreads, 0, s>>>(T, B, r, d, v, tl, gamma, gl,
                                                     static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// args: host pointer to an sgt::PPOArgs (device pointers inside), args.split
// blocks per entry of args.perm (n_blk of them); out [ppo_out_len(H)]
int sgt_ppo_grad_launch(const void* args, int n_blk, void* out, void* stream) {
  return launch_grad(*static_cast<const sgt::PPOArgs*>(args), n_blk, out, stream);
}

// K4: args.main is the [12, N] buffer; its adv/ret rows 10-11 are read in
// place of a second buffer (args.advret is ignored)
int sgt_ppo_grad12_launch(const void* args, int n_blk, void* out, void* stream) {
  return launch_grad(sgt::ppo_grad12_args(*static_cast<const sgt::PPOArgs*>(args)), n_blk, out,
                     stream);
}

// The dynamic shared memory (bytes) of one block of K3, K4 or K5 at width H
// and compute dtype bf16 (0 float32, 1 bfloat16)
int sgt_ppo_smem_bytes(int H, int bf16) { return (int)sgt::ppo_smem_bytes(H, bf16 != 0); }

// K5: args is a host pointer to an sgt::EpochArgs; one cooperative launch of
// min(args.grid, the blocks the card holds at once) blocks, which walk the
// args.nblk * args.g.split work items of each minibatch.  Returns
// cudaErrorCooperativeLaunchTooLarge, without launching, when not even one
// block fits on an SM.
int sgt_ppo_epoch_launch(const void* args, void* stream) {
  sgt::EpochArgs e = *static_cast<const sgt::EpochArgs*>(args);
  if (e.n_mb <= 0 || e.nblk <= 0 || e.g.H <= 0 || e.g.bs <= 0 || e.g.split <= 0 ||
      e.grid <= 0 || e.grid > sgt::epoch_items(e) || (e.g.bf16 != 0 && e.g.bf16 != 1) ||
      !bf16_fits(e.g))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sgt::ppo_smem_bytes(e.g.H, e.g.bf16);
  const void* kernel =
      e.g.bf16 ? (const void*)ppo_epoch_kernel<true> : (const void*)ppo_epoch_kernel<false>;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGradThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((long long)per_sm * sms < e.grid) e.grid = per_sm * sms;
  void* kargs[] = {&e};
  err = cudaLaunchCooperativeKernel(kernel, dim3(e.grid),
                                    dim3(kGradThreads), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
