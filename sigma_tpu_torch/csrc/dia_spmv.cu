// DIA (diagonal-format) sparse matrix-vector products for Hopper (sm_90a).
//
// Two kernels, each a port of a Pallas TPU kernel of the JAX package:
//
//   dia_spmv      replaces sigma_tpu/ops/spmv_pallas.py
//                 dia_spmv_pallas_blocked: y = A x from full-storage DIA,
//                 rectangular n x m.
//   dia_sym_spmv  replaces sigma_tpu/ops/spmv_pallas.py
//                 dia_sym_spmv_pallas_blocked: y = A x from the upper
//                 diagonals (offsets >= 0) of a symmetric matrix.
//
// Layout.  Values are (D, stride) row-major: val(d, i) = data[d*stride + i]
// holds A[i, i + offsets[d]].  Offsets arrive as a device int64 array and
// are staged in shared memory in chunks of kOffsetChunk, so D is a runtime
// value and a band of any width runs in one launch (the TPU kernel needed
// VMEM tile picks and a chunked wrapper for that).
//
// What bounds them.  SpMV is memory bound: at best each launch reads every
// stored value once and x and y once, D*sizeof(val) + sizeof(x) + sizeof(y)
// bytes per row (36 B/row for the f32 7-point stencil in full storage,
// 24 B/row for its 4 upper diagonals).  The design keeps the traffic at that
// floor with the simplest access pattern the card coalesces: one thread per
// output row, so neighbouring threads read neighbouring addresses of each
// value row and of each shifted x window (x[i + o]).  The x windows of the
// D diagonals overlap, and at the 10.1M-row north star the largest offset
// is nx*nx = 46,656 rows (186 KB of f32 x), far inside the 50 MB L2, so x
// comes from device memory about once.
//
// The symmetric kernel reads the mirror term val(d, i - o) * x[i - o] as a
// second coalesced stream shifted back by o.  A block of 256 rows touches
// value rows i and i - o; the second read hits lines that a block at most
// 46,656 rows earlier loaded, and only 4 x 46,656 x 4 B = 746 KB of f32
// values (plus x) stream between the two reads, so the lines are still in
// L2 and the values also come from device memory about once.  Every row
// is written exactly once: no atomics and no spill between blocks.
//
// Masking.  Out-of-range terms (column outside [0, m), or a mirror row
// before 0) are skipped, never multiplied by zero: NaN * 0 is NaN, and the
// TPU kernel selects rather than multiplies for the same reason.
//
// Types.  Accumulation is in the vector type X (the DTYPE CONVENTION of
// DIAMatrix: compute in x's dtype, cast values to it).  Instantiated value
// x vector pairs: (f32, f32), (bf16, f32), (f64, f64), (f32, f64),
// (bf16, f64).  Index arithmetic d*stride + i is 64-bit: at 245 diagonals
// x 10M rows it passes 2^31.
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype pair it does not
// instantiate).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsetChunk = 1024;

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

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                    const int64_t* __restrict__ offsets, X* __restrict__ y,
                    int64_t D, int64_t stride, int64_t n, int64_t m) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  X acc = X(0);
  for (int64_t d0 = 0; d0 < D; d0 += kOffsetChunk) {
    const int64_t dn = D - d0 < kOffsetChunk ? D - d0 : kOffsetChunk;
    stage_offsets(s_off, offsets, d0, dn);
    if (i < n) {
      for (int64_t t = 0; t < dn; ++t) {
        const int64_t j = i + s_off[t];
        if (j >= 0 && j < m) acc += to_x<X>(data[(d0 + t) * stride + i]) * x[j];
      }
    }
  }
  if (i < n) y[i] = acc;
}

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads)
    dia_sym_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                        const int64_t* __restrict__ offsets, X* __restrict__ y,
                        int64_t D, int64_t stride, int64_t n) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  X acc = X(0);
  for (int64_t d0 = 0; d0 < D; d0 += kOffsetChunk) {
    const int64_t dn = D - d0 < kOffsetChunk ? D - d0 : kOffsetChunk;
    stage_offsets(s_off, offsets, d0, dn);
    if (i < n) {
      for (int64_t t = 0; t < dn; ++t) {
        const int64_t o = s_off[t];
        const V* row = data + (d0 + t) * stride;
        // upper (and main) term: A[i, i+o] = val(d, i); the lower bound
        // only keeps a (rejected) negative offset from reading before x
        if (i + o >= 0 && i + o < n) acc += to_x<X>(row[i]) * x[i + o];
        // mirror term: A[i, i-o] = A[i-o, i] = val(d, i-o)
        if (o > 0 && i >= o) acc += to_x<X>(row[i - o]) * x[i - o];
      }
    }
  }
  if (i < n) y[i] = acc;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename V, typename X>
cudaError_t launch_full(const void* data, const void* x, const void* offsets,
                        void* y, int64_t D, int64_t stride, int64_t n,
                        int64_t m, cudaStream_t stream) {
  dia_spmv_kernel<V, X><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch_sym(const void* data, const void* x, const void* offsets,
                       void* y, int64_t D, int64_t stride, int64_t n,
                       cudaStream_t stream) {
  dia_sym_spmv_kernel<V, X><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sigma_dia_spmv(int device, int vtype, int xtype, const void* data,
                              const void* x, const void* offsets, void* y,
                              int64_t D, int64_t stride, int64_t n, int64_t m,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_full<float, float>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kBF16) return launch_full<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, m, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_full<double, double>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kF32) return launch_full<float, double>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kBF16) return launch_full<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, m, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int sigma_dia_sym_spmv(int device, int vtype, int xtype,
                                  const void* data, const void* x,
                                  const void* offsets, void* y, int64_t D,
                                  int64_t stride, int64_t n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_sym<float, float>(data, x, offsets, y, D, stride, n, s);
    if (vtype == kBF16) return launch_sym<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_sym<double, double>(data, x, offsets, y, D, stride, n, s);
    if (vtype == kF32) return launch_sym<float, double>(data, x, offsets, y, D, stride, n, s);
    if (vtype == kBF16) return launch_sym<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, s);
  }
  return cudaErrorInvalidValue;
}
