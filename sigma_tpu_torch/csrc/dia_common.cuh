// Helpers shared by the DIA kernels (dia_spmv.cu, dia_spmm.cu).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sigma_dia {

constexpr int kThreads = 256;
constexpr int kOffsetChunk = 1024;

// dtype codes passed by the Python wrappers (ops/spmv_dia.py _CODES)
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename X>
__device__ __forceinline__ X to_x(float v) {
  return static_cast<X>(v);
}
template <typename X>
__device__ __forceinline__ X to_x(double v) {
  return static_cast<X>(v);
}
template <typename X>
__device__ __forceinline__ X to_x(__nv_bfloat16 v) {
  return static_cast<X>(__bfloat162float(v));
}

// Stage offsets[d0 : d0 + dn] into shared memory (whole block takes part).
__device__ __forceinline__ void stage_offsets(int64_t* s_off,
                                              const int64_t* __restrict__ offsets,
                                              int64_t d0, int64_t dn) {
  __syncthreads();
  for (int64_t t = threadIdx.x; t < dn; t += blockDim.x) s_off[t] = offsets[d0 + t];
  __syncthreads();
}

inline unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

}  // namespace sigma_dia
