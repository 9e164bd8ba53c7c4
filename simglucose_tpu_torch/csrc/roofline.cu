// K6: the roofline probe as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/roofline_rollout.py::make_chain (its body
// :69-76, launched by the pl.pallas_call at :80-86): P independent chains of
// K applications of one elementwise op on an [8, 128] f32 tile, summed into
// one tile.  The port uses it to measure the card's rate for each of the
// seven ops, at full occupancy and at the rollout kernel K1a's own launch
// shape, and from them the ceiling the ops put on K1a
// (simglucose_tpu_torch/tools/roofline_rollout.py).
//
// Design: one thread per element of a replicated tile.  Thread i keeps its
// P chains in registers, seeded x[i % 1024] + p * 0.01, runs K applications,
// sums the chains and writes one float.  K is a run-time argument and the
// sum is stored, so nvcc can neither fold nor drop the chain.  The TPU's G
// sequential grid steps over one tile become the number of threads: enough
// blocks to fill the card, or K1a's 32-thread blocks.
//
// Bound: instruction issue, never bytes (4 bytes read and 4 written per
// thread against K * P ops).  Each op compiles to the sequence K1a gets
// (one FFMA or FMUL; tanhf, expf, logf: MUFU plus FFMA range reduction;
// `/`: MUFU.RCP, Newton FFMAs and a range check with its branch; select:
// both arms and a compare), and at 16 chains a thread and full occupancy
// the SM's four schedulers issuing that sequence, one warp instruction a
// clock each, are the busiest resource for every op, ahead of its pipe
// (chip_smoke.py::issue_bound over tools/roofline_rollout.py::app_counts).
//
// Built by simglucose_tpu_torch/ops/build.py with the other kernels; the C
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include "roofline_math.cuh"

namespace sgt_k6 {

template <int OP, int P>
__global__ void chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                             int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = sgt::chain_sum<OP, P>(x[i % sgt::CHAIN_TILE], K);
}

template <int P>
cudaError_t launch_op(int op, const float* x, float* out, int n, int blocks, int threads,
                      int K, cudaStream_t s) {
  switch (op) {
#define SGT_K6_CASE(OPC)                                                   \
  case sgt::OPC:                                                           \
    chain_kernel<sgt::OPC, P><<<blocks, threads, 0, s>>>(x, out, n, K); \
    break;
    SGT_K6_CASE(OP_FMA)
    SGT_K6_CASE(OP_MUL)
    SGT_K6_CASE(OP_TANH)
    SGT_K6_CASE(OP_EXP)
    SGT_K6_CASE(OP_LOG)
    SGT_K6_CASE(OP_DIV)
    SGT_K6_CASE(OP_SELECT)
#undef SGT_K6_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace sgt_k6

extern "C" {

// op: the index into ops/roofline.py OPS; P in {1, 4, 16}; x: the 1024-float
// tile on the card; out: n_threads floats on the card.  Any other op or P,
// or a bad shape, returns cudaErrorInvalidValue without launching.
int sgt_chain_launch(int op, int P, const void* x, void* out, int n_threads,
                     int threads_per_block, int K, void* stream) {
  if (n_threads <= 0 || threads_per_block <= 0 || threads_per_block > 1024 || K < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_threads + threads_per_block - 1) / threads_per_block;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1:
      return (int)sgt_k6::launch_op<1>(op, xf, of, n_threads, blocks, threads_per_block, K, s);
    case 4:
      return (int)sgt_k6::launch_op<4>(op, xf, of, n_threads, blocks, threads_per_block, K, s);
    case 16:
      return (int)sgt_k6::launch_op<16>(op, xf, of, n_threads, blocks, threads_per_block, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
