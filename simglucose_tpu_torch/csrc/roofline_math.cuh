// The seven elementwise ops of the roofline probe K6 (roofline.cu), shared
// by the CUDA kernel and any host build of this header.
//
// Each op is one application of tools/roofline_rollout.py::make_chain's
// `one` (:52-67), its constants rounded to float32 as JAX rounds them, and
// written with the libm calls and the IEEE division that rollout_math.cuh
// uses (tanhf, expf, logf, `/`).  Built with the port's NVCC_FLAGS (no fast
// math), the rates are those the rollout kernel K1a gets.  `fma` is a
// multiply and an add: nvcc contracts it into one FFMA; a host build with
// -ffp-contract=off rounds twice, as PyTorch does.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define SGT_RF_HD __host__ __device__ __forceinline__
#define SGT_RF_UNROLL _Pragma("unroll")
#else
#define SGT_RF_HD inline
#define SGT_RF_UNROLL
#endif

namespace sgt {

// the op codes of ops/roofline.py OPS, in its order
enum ChainOp : int {
  OP_FMA = 0,
  OP_MUL = 1,
  OP_TANH = 2,
  OP_EXP = 3,
  OP_LOG = 4,
  OP_DIV = 5,
  OP_SELECT = 6
};

constexpr int CHAIN_TILE = 8 * 128;  // the TPU probe's [8, 128] tile

template <int OP>
SGT_RF_HD float chain_op(float y) {
  if constexpr (OP == OP_FMA) {
    return y * 1.000001f + 1e-6f;
  } else if constexpr (OP == OP_MUL) {
    return y * 1.000001f;
  } else if constexpr (OP == OP_TANH) {
    return tanhf(y);
  } else if constexpr (OP == OP_EXP) {
    return expf(y * 1e-6f);  // keeps the chain finite
  } else if constexpr (OP == OP_LOG) {
    return logf(fabsf(y) + 1.0f);
  } else if constexpr (OP == OP_DIV) {
    return 1.0f / (y + 1.7f);
  } else {
    static_assert(OP == OP_SELECT, "unknown chain op");
    return y > 0.5f ? y * 0.999f : y + 1e-4f;
  }
}

// Chain p's seed offset: the double p * 0.01 rounded to float32 once, as
// JAX and PyTorch round the Python float.
SGT_RF_HD float chain_seed(int p) { return (float)((double)p * 0.01); }

// One element of the probe: P independent chains seeded x + seed(p), each
// K applications of the op, summed in p order.  K is a run-time value and
// the caller stores the sum, so the compiler can neither fold nor drop the
// chain; only the loop over P is unrolled.
template <int OP, int P>
SGT_RF_HD float chain_sum(float x, int K) {
  float ys[P];
SGT_RF_UNROLL
  for (int p = 0; p < P; ++p) ys[p] = x + chain_seed(p);
  for (int k = 0; k < K; ++k) {
SGT_RF_UNROLL
    for (int p = 0; p < P; ++p) ys[p] = chain_op<OP>(ys[p]);
  }
  float acc = ys[0];
SGT_RF_UNROLL
  for (int p = 1; p < P; ++p) acc = acc + ys[p];
  return acc;
}

}  // namespace sgt
