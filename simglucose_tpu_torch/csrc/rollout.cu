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

int sgt_philox_probe(void* out, int n, uint32_t k0, uint32_t k1, uint32_t c1,
                     uint32_t c2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  philox_probe_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, k0, k1, c1, c2);
  return (int)cudaGetLastError();
}

}  // extern "C"
