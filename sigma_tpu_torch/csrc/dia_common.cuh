// Helpers shared by the DIA and pruned kernels (dia_spmv.cu, dia_spmm.cu,
// pruned.cu).
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

// Addressing of k panels of one vector with panel-block length B.
struct Panels {
  int64_t B;   // panel-block length
  int64_t kB;  // k * B: the distance between two blocks of one panel
  int shift;   // log2(B), or -1 when one block holds the whole vector

  // position of element i of panel 0; panel j is j * B further on
  __device__ __forceinline__ int64_t at(int64_t i) const {
    return shift < 0 ? i : (i >> shift) * kB + (i & (B - 1));
  }
  // elements of one panel, padding included
  int64_t rows(int64_t len) const {
    return shift < 0 ? len : ((len + B - 1) >> shift) << shift;
  }
};

// False when B is neither a power of two nor long enough to hold the
// whole vector of ``len`` elements in one block.
inline bool make_panels(int64_t B, int64_t k, int64_t len, Panels* p) {
  if (B < 1) return false;
  int shift = -1;
  if ((B & (B - 1)) == 0) {
    shift = 0;
    while ((int64_t(1) << shift) < B) ++shift;
  } else if (B < len) {
    return false;
  }
  *p = Panels{B, k * B, shift};
  return true;
}

}  // namespace sigma_dia
