// K2 (GAE) and K3 (the fused PPO grad step) as CUDA kernels for Hopper
// (sm_90a), built into the same library as the rollout kernels.
//
// K2 replaces simglucose_tpu/ops/pallas_ppo_learner.py::_gae_kernel (via
// gae_pack).  One thread per lane walks t = T-1 .. 0; a warp's loads and
// stores are consecutive lanes of one time row, so they coalesce.  It moves
// ~20 bytes per lane-step (10.5 MB at B=8192, T=64) and is bound by the
// latency of its T dependent steps, not by bandwidth.
//
// K3 replaces ::_kernel2 (via ppo_grad_step_gather2): forward, clipped
// surrogate and value loss, and the hand-derived backward over one
// minibatch gathered by shuffle-block ids.  One CUDA block per shuffle
// block reads its id from perm (the TPU kernel's scalar prefetch); the
// weights, a tile of 32 rows and its activations (h1, h2, dg2) sit in
// shared memory, and each block's gradient and loss sums are written to
// its own slot of a scratch buffer, which a second kernel sums over blocks
// in a fixed order (no atomics: a step is deterministic).  A grad step is
// ~27 KFLOP per row of f32 FMAs on CUDA cores (3.5 GFLOP at 131072 rows),
// with about one shared-memory load per FMA: bound by shared-memory issue,
// and at the bench shape only 64 blocks run on the 132 SMs.  Tensor cores
// and a split of each shuffle block over more SMs are later work.

#include <cuda_runtime.h>

#include "ppo_math.cuh"

namespace {

constexpr int kGaeThreads = 64;
constexpr int kGradThreads = 256;
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kGaeThreads)
    gae_kernel(int T, int B, const float* __restrict__ reward,
               const float* __restrict__ done, const float* __restrict__ value,
               const float* __restrict__ tail, float gamma, float gl,
               float* __restrict__ out) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)B) return;
  sgt::gae_lane(T, (size_t)B, b, reward, done, value, tail, gamma, gl, out);
}

__global__ void __launch_bounds__(kGradThreads) ppo_grad_kernel(const sgt::PPOArgs a) {
  extern __shared__ float smem[];
  sgt::ppo_grad_block(a, blockIdx.x, smem, threadIdx.x, blockDim.x);
}

// out[i] = sum over blocks of partial[blk, i], blocks in order
__global__ void __launch_bounds__(kReduceThreads)
    block_sum_kernel(const float* __restrict__ partial, int n_blk, int L,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  out[i] = sgt::block_sum(partial, n_blk, L, i);
}

}  // namespace

extern "C" {

// reward/done/value [T, B], tail [B], out [2, T*B]; device pointers
int sgt_gae_launch(int T, int B, const void* reward, const void* done, const void* value,
                   const void* tail, float gamma, float gl, void* out, void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  gae_kernel<<<(B + kGaeThreads - 1) / kGaeThreads, kGaeThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      T, B, static_cast<const float*>(reward), static_cast<const float*>(done),
      static_cast<const float*>(value), static_cast<const float*>(tail), gamma, gl,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// args: host pointer to an sgt::PPOArgs (device pointers inside), one block
// per entry of args.perm (n_blk of them); out [ppo_out_len(H)]
int sgt_ppo_grad_launch(const void* args, int n_blk, void* out, void* stream) {
  const sgt::PPOArgs a = *static_cast<const sgt::PPOArgs*>(args);
  if (n_blk <= 0 || a.H <= 0 || a.bs <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sgt::ppo_smem_floats(a.H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ppo_grad_kernel<<<n_blk, kGradThreads, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int L = sgt::ppo_out_len(a.H);
  block_sum_kernel<<<(L + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      a.partial, n_blk, L, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
