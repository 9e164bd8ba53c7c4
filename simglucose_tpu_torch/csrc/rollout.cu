// K1a: the closed-loop cohort rollout as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel simglucose_tpu/ops/pallas_rollout.py::_make_kernel
// (launched by make_pallas_rollout's pl.pallas_call) for the PID,
// basal-bolus and constant-basal controllers.
//
// Design: one thread per patient.  The patient's whole simulator state (13
// ODE states, eating machine, sensor lattice, meal plan, controller) lives
// in registers for the T steps of the call; a loop over steps inside the
// thread takes the place of the TPU's sequential time-chunk grid axis, and
// there is no shared memory.  Parameters are read from the [50, B] planes,
// trajectories written to [6, T, B] planes: thread b touches element b of
// each plane, so a warp's loads and stores are coalesced.
//
// Bound: per env step a patient does sample_time RK4 minutes (4 RHS
// evaluations, two tanhf each) plus Philox, Johnson-SU and the risk
// (logf/powf): arithmetic and transcendental latency on one thread, with
// 24 bytes of trajectory stored per step.  With 32 threads per block a
// 4096-patient cohort is 128 single-warp blocks on 132 SMs: nothing hides
// latency yet; filling the card is later work.
//
// Built by simglucose_tpu_torch/ops/build.py with nvcc into a shared library
// loaded through ctypes; the C launchers below return cudaGetLastError().

#include <cuda_runtime.h>

#include "rollout_math.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    rollout_kernel(const sgt::RolloutCfg c, const float* __restrict__ params,
                   const int32_t* __restrict__ meal_times,
                   const float* __restrict__ meal_amounts,
                   const float* __restrict__ rnoise, const float* __restrict__ snoise,
                   const float* __restrict__ sf_in, const int32_t* __restrict__ si_in,
                   float* __restrict__ out, float* __restrict__ rst,
                   float* __restrict__ sf_out, int32_t* __restrict__ si_out) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)c.B) return;
  sgt::rollout_patient(c, b, params, meal_times, meal_amounts, rnoise, snoise, sf_in,
                       si_in, out, rst, sf_out, si_out);
}

// K1b: the same rollout with the 'nn' controller (replaces the TPU kernel's
// controller='nn' configs, pallas_rollout.py:804-984 and the tail rows
// :1227-1252).  A separate entry, so K1a's code and registers stay as they
// were.  Per patient-step the relu MLP 7 -> H -> H -> (mu, v) adds about
// (7 + H) * H + 2 * H FMAs (4.7K at H=64) to K1a's ~2.3K instructions, all
// on the thread's own patient: arithmetic-bound like K1a.  The packed
// weights [H, H+16] are loaded into shared memory once per block; every
// thread of a warp reads the same weight at the same time (a broadcast).
// Each thread's layer-1 activations live in shared memory laid out
// [H][blockDim] (conflict-free, no local-memory spill); layer 2 is folded
// into both heads one unit at a time, so h2 is never stored.  Shared
// memory: (H * (H + 16) + H * 32) * 4 bytes = 28.7 KB at H=64; above 48 KB
// (H=128: 90 KB) the launcher opts in to dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
    rollout_nn_kernel(const sgt::RolloutCfg c, const float* __restrict__ params,
                      const int32_t* __restrict__ meal_times,
                      const float* __restrict__ meal_amounts,
                      const float* __restrict__ rnoise, const float* __restrict__ snoise,
                      const float* __restrict__ sf_in, const int32_t* __restrict__ si_in,
                      const float* __restrict__ weights, float* __restrict__ out,
                      float* __restrict__ lrn, float* __restrict__ obs,
                      float* __restrict__ rst, float* __restrict__ sf_out,
                      int32_t* __restrict__ si_out) {
  extern __shared__ float smem[];
  const int n_w = c.nn_hidden * (c.nn_hidden + 16);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) smem[i] = weights[i];
  __syncthreads();
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)c.B) return;
  const sgt::NNArgs nn{smem, smem + n_w + threadIdx.x, (int)blockDim.x, lrn, obs};
  sgt::rollout_patient_nn(c, b, params, meal_times, meal_amounts, rnoise, snoise, sf_in,
                          si_in, out, rst, sf_out, si_out, nn);
}

// Philox words at counters (i, c1, c2, 0), i < n: lets a check compare the
// kernel's generator with the plain version bit for bit.
__global__ void philox_probe_kernel(uint32_t* __restrict__ out, int n, uint32_t k0,
                                    uint32_t k1, uint32_t c1, uint32_t c2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[4];
  sgt::philox4x32_10((uint32_t)i, c1, c2, 0u, k0, k1, w);
  for (int j = 0; j < 4; ++j) out[4 * i + j] = w[j];
}

}  // namespace

extern "C" {

// cfg: host pointer to an sgt::RolloutCfg (copied into the launch by value).
// All other pointers are device pointers; see sgt::rollout_patient.
int sgt_rollout_launch(const void* cfg, const void* params, const void* meal_times,
                       const void* meal_amounts, const void* rnoise, const void* snoise,
                       const void* sf_in, const void* si_in, void* out, void* rst,
                       void* sf_out, void* si_out, void* stream) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  if (c.B <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (c.B + kThreads - 1) / kThreads;
  rollout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const float*>(params), static_cast<const int32_t*>(meal_times),
      static_cast<const float*>(meal_amounts), static_cast<const float*>(rnoise),
      static_cast<const float*>(snoise), static_cast<const float*>(sf_in),
      static_cast<const int32_t*>(si_in), static_cast<float*>(out),
      static_cast<float*>(rst), static_cast<float*>(sf_out),
      static_cast<int32_t*>(si_out));
  return (int)cudaGetLastError();
}

// K1b.  weights: [H, H+16] packed policy weights; lrn [10, T, B] (emit
// mode) or obs [6, T, B] (plane mode), the other null; rst [3, B] (emit) or
// [7, B].
int sgt_rollout_nn_launch(const void* cfg, const void* params, const void* meal_times,
                          const void* meal_amounts, const void* rnoise, const void* snoise,
                          const void* sf_in, const void* si_in, const void* weights,
                          void* out, void* lrn, void* obs, void* rst, void* sf_out,
                          void* si_out, void* stream) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  if (c.B <= 0 || c.nn_hidden <= 0) return (int)cudaErrorInvalidValue;
  const int H = c.nn_hidden;
  const size_t smem = (size_t)(H * (H + 16) + H * kThreads) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rollout_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (c.B + kThreads - 1) / kThreads;
  rollout_nn_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const float*>(params), static_cast<const int32_t*>(meal_times),
      static_cast<const float*>(meal_amounts), static_cast<const float*>(rnoise),
      static_cast<const float*>(snoise), static_cast<const float*>(sf_in),
      static_cast<const int32_t*>(si_in), static_cast<const float*>(weights),
      static_cast<float*>(out), static_cast<float*>(lrn), static_cast<float*>(obs),
      static_cast<float*>(rst), static_cast<float*>(sf_out), static_cast<int32_t*>(si_out));
  return (int)cudaGetLastError();
}

int sgt_philox_probe(void* out, int n, uint32_t k0, uint32_t k1, uint32_t c1,
                     uint32_t c2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  philox_probe_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, k0, k1, c1, c2);
  return (int)cudaGetLastError();
}

}  // extern "C"
