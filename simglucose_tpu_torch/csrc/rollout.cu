// K1a: the closed-loop cohort rollout as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel simglucose_tpu/ops/pallas_rollout.py::_make_kernel
// (launched by make_pallas_rollout's pl.pallas_call) for the PID,
// basal-bolus and constant-basal controllers.
//
// Design: one patient per group of G lanes (sgt::Lanes; K1A_GROUP for K1a,
// K1B_GROUP for K1b, rollout_math.cuh).  The patient's whole simulator
// state (13 ODE states, eating machine, sensor lattice, meal plan,
// controller) lives in the registers of each lane of its group for the T
// steps of the call, every lane running the same serial code on the same
// inputs; a loop over steps inside the thread takes the place of the TPU's
// sequential time-chunk grid axis.  Parameters are read from the [50, B]
// planes, trajectories written to [6, T, B] planes, each output row by one
// lane of the group: a warp's loads and stores cover 32 / G consecutive
// patients.
//
// Bound: per env step a patient does sample_time RK4 minutes (4 RHS
// evaluations, two tanhf each) plus Philox, Johnson-SU and the risk
// (logf/powf): arithmetic and transcendental latency on one thread, with
// 24 bytes of trajectory stored per step.  K1a keeps one lane per patient in
// 32-thread blocks (a 4096-patient cohort is 128 single-warp blocks on 132
// SMs): more lanes per patient only repeat its serial path, and the RHS's
// four compartments split over four lanes ran ~30% slower on an H100, since
// a warp runs different code on its lanes one branch after another
// (PERF.md).
//
// Built by simglucose_tpu_torch/ops/build.py with nvcc into a shared library
// loaded through ctypes; the C launchers below return cudaGetLastError().

#include <cuda_runtime.h>

#include "rollout_math.cuh"

namespace {

__global__ void __launch_bounds__(sgt::K1A_THREADS)
    rollout_kernel(const sgt::RolloutCfg c, const float* __restrict__ params,
                   const int32_t* __restrict__ meal_times,
                   const float* __restrict__ meal_amounts,
                   const float* __restrict__ rnoise, const float* __restrict__ snoise,
                   const float* __restrict__ sf_in, const int32_t* __restrict__ si_in,
                   float* __restrict__ out, float* __restrict__ rst,
                   float* __restrict__ sf_out, int32_t* __restrict__ si_out) {
  const size_t b = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / sgt::K1A_GROUP;
  if (b >= (size_t)c.B) return;
  sgt::rollout_patient(c, b, params, meal_times, meal_amounts, rnoise, snoise, sf_in, si_in,
                       out, rst, sf_out, si_out, sgt::lanes_of(threadIdx.x, sgt::K1A_GROUP));
}

// K1b: the same rollout with the 'nn' controller (replaces the TPU kernel's
// controller='nn' configs, pallas_rollout.py:804-984 and the tail rows
// :1227-1252).  A separate entry, so K1a's code and registers stay as they
// were.  Per patient-step the relu MLP 7 -> H -> H -> (mu, v) adds
// (7 + H) * H + 2 * H FMAs (4.7K at H=64) to K1a's ~2.3K instructions.  The
// TPU kernel runs layer 2 as a matrix product over 128 patients; here each
// patient's G lanes split both layers by output unit (sgt::nn_mlp), so a
// warp runs 32 / G patients and the card holds G times the warps of one
// thread per patient (B=8192, G=4: 1024 warps, ~7.8 per SM, where one
// thread per patient gave ~2).  Shared memory, per block of K1B_THREADS:
// the packed weights, rows padded from H+16 to H+20 floats (a row stride of
// 4 mod 8 banks puts the 16-byte loads of 8 consecutive units on distinct
// banks), loaded once per block and read by every patient of a warp at the
// same address; then each patient's H layer-1 activations, H+4 floats
// apart (distinct banks for the 8 patients of a 16-byte load's phase).
// (H * (H + 20) + K1B_THREADS / G * (H + 4)) * 4 bytes = 30.2 KB at H=64,
// 92.7 KB at H=128 (G=4): above 48 KB the launcher opts in to dynamic
// shared memory.
__global__ void __launch_bounds__(sgt::K1B_THREADS)
    rollout_nn_kernel(const sgt::RolloutCfg c, const float* __restrict__ params,
                      const int32_t* __restrict__ meal_times,
                      const float* __restrict__ meal_amounts,
                      const float* __restrict__ rnoise, const float* __restrict__ snoise,
                      const float* __restrict__ sf_in, const int32_t* __restrict__ si_in,
                      const float* __restrict__ weights, float* __restrict__ out,
                      float* __restrict__ lrn, float* __restrict__ obs,
                      float* __restrict__ rst, float* __restrict__ sf_out,
                      int32_t* __restrict__ si_out) {
  constexpr int G = sgt::K1B_GROUP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = c.nn_hidden, ld = H + 16, lds = H + 20;
  for (int i = threadIdx.x; i < H * ld; i += blockDim.x) {
    const int r = i / ld;
    smem[r * lds + (i - r * ld)] = weights[i];
  }
  __syncthreads();
  const int p = threadIdx.x / G;  // the patient's place in the block
  const size_t b = (size_t)blockIdx.x * (blockDim.x / G) + p;
  if (b >= (size_t)c.B) return;
  const sgt::NNArgs nn{smem, lds, smem + H * lds + p * (H + 4), lrn, obs};
  sgt::rollout_patient_nn(c, b, params, meal_times, meal_amounts, rnoise, snoise, sf_in,
                          si_in, out, rst, sf_out, si_out, nn, sgt::lanes_of(threadIdx.x, G));
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

// Blocks of `threads` lanes covering B patients of G lanes each.
int blocks_for(int B, int G, int threads) {
  return (int)(((long long)B * G + threads - 1) / threads);
}

}  // namespace

extern "C" {

// cfg: host pointer to an sgt::RolloutCfg (copied into the launch by
// value).  All other pointers are device pointers; see
// sgt::rollout_patient.
int sgt_rollout_launch(const void* cfg, const void* params, const void* meal_times,
                       const void* meal_amounts, const void* rnoise, const void* snoise,
                       const void* sf_in, const void* si_in, void* out, void* rst,
                       void* sf_out, void* si_out, void* stream) {
  const sgt::RolloutCfg c = *static_cast<const sgt::RolloutCfg*>(cfg);
  if (c.B <= 0) return (int)cudaErrorInvalidValue;
  rollout_kernel<<<blocks_for(c.B, sgt::K1A_GROUP, sgt::K1A_THREADS), sgt::K1A_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
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
  if (c.B <= 0 || c.nn_hidden <= 0 || c.nn_hidden % 8) return (int)cudaErrorInvalidValue;
  const int H = c.nn_hidden;
  const size_t smem =
      (size_t)(H * (H + 20) + sgt::K1B_THREADS / sgt::K1B_GROUP * (H + 4)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rollout_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rollout_nn_kernel<<<blocks_for(c.B, sgt::K1B_GROUP, sgt::K1B_THREADS), sgt::K1B_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
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
