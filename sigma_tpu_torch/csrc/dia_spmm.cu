// DIA (diagonal-format) sparse matrix times k dense panels for Hopper
// (sm_90a): Y = A X for 1 <= k <= 16 right-hand sides.
//
// Two kernels, each a port of two Pallas TPU kernels of the JAX package
// (sigma_tpu/ops/spmv_pallas.py):
//
//   dia_spmm      replaces _dia_spmm_core (RHS-major (k, m) panels, also
//                 behind the (m, k) entry dia_spmm_pallas_blocked) and
//                 dia_spmm_interleaved ((k * ceil(m/128), 128) panels):
//                 Y = A X from full-storage DIA, rectangular n x m.
//   dia_sym_spmm  replaces dia_sym_spmm_rhs_major and
//                 dia_sym_spmm_interleaved: Y = A X from the upper
//                 diagonals (offsets >= 0) of a symmetric matrix.
//
// Panel layout is data, not code.  Element i of panel j lives at
//
//     (i / B) * (B * k) + j * B + (i % B)
//
// where B is the panel-block length the caller passes for x and for y:
// B = the vector's length is the RHS-major (k, m) layout, B = 128 the
// interleaved layout of interleave_panels, B = 1 the (m, k) column layout.
// So one kernel reads and writes all three directly: no transpose or
// de-interleave pass around it.  A power-of-two B is addressed with a
// shift and a mask; any other B must hold the whole vector (one block).
// Rows of y past n (the interleaved layout's zero padding up to a multiple
// of 128) are written as zeros: the block solvers' Gram products run over
// the padded layout.
//
// What bounds them.  Memory: the point of the TPU kernels, kept here, is
// that each stored value is read once for all k right-hand sides.  The
// byte floor of one product is the stored values once plus k x-panels and
// k y-panels: for the f32 7-point stencil at nx=216 (10,077,696 rows,
// 70,263,936 stored values) and k=8, 281 + 322 + 322 MB.  The design is
// the SpMV kernels' (dia_spmv.cu) with k accumulators: one thread per
// output row, offsets staged in shared memory in chunks, each value loaded
// once, converted to the vector type and multiplied into k accumulators
// held in registers.  Neighbouring threads read neighbouring rows, so the
// value stream and, in the RHS-major and interleaved layouts, every panel
// stream is coalesced; in the column layout a warp reads 32 * k
// consecutive elements over its k loads, which L1 serves.  The D shifted
// windows of each panel overlap and the largest stencil offset (46,656
// rows at nx=216, 1.5 MB of eight f32 panels) is far inside the 50 MB L2,
// so x comes from device memory about once.
//
// The symmetric kernel adds the mirror term val(d, i - o) * X(j, i - o)
// for o > 0, a second coalesced value stream shifted back by o rows.  As
// in dia_sym_spmv, only 4 x 46,656 f32 values (746 KB) plus 8 panels'
// windows stream between a value line's two reads, so the second read
// hits L2 and the values still come from device memory about once.
//
// Registers.  k is a runtime value; the accumulators are an array of a
// compile-time bound K in {4, 8, 16} (the smallest that holds k) indexed
// only inside fully unrolled loops guarded by j < k, so they stay in
// registers (ptxas -v: no spill stores).
//
// Masking, types, indexing: as in dia_spmv.cu.  Out-of-range terms are
// skipped, never multiplied by zero (NaN * 0 is NaN); accumulation is in
// the vector type; the five (value, vector) dtype pairs of the SpMV
// kernels; all index arithmetic is 64-bit.
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k or a
// panel-block length it does not take.

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

template <typename V, typename X, int K>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                    const int64_t* __restrict__ offsets, X* __restrict__ y,
                    int64_t D, int64_t stride, int64_t n, int64_t m, int k,
                    Panels px, Panels py, int64_t rows_out) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  X acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = X(0);
  for (int64_t d0 = 0; d0 < D; d0 += kOffsetChunk) {
    const int64_t dn = D - d0 < kOffsetChunk ? D - d0 : kOffsetChunk;
    stage_offsets(s_off, offsets, d0, dn);
    if (i < n) {
      for (int64_t t = 0; t < dn; ++t) {
        const int64_t c = i + s_off[t];
        if (c >= 0 && c < m) {
          const X v = to_x<X>(data[(d0 + t) * stride + i]);
          const X* xc = x + px.at(c);
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < k) acc[j] += v * xc[j * px.B];
        }
      }
    }
  }
  if (i < rows_out) {
    X* yi = y + py.at(i);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) yi[j * py.B] = i < n ? acc[j] : X(0);
  }
}

template <typename V, typename X, int K>
__global__ void __launch_bounds__(kThreads)
    dia_sym_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                        const int64_t* __restrict__ offsets, X* __restrict__ y,
                        int64_t D, int64_t stride, int64_t n, int k, Panels p,
                        int64_t rows_out) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  X acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = X(0);
  for (int64_t d0 = 0; d0 < D; d0 += kOffsetChunk) {
    const int64_t dn = D - d0 < kOffsetChunk ? D - d0 : kOffsetChunk;
    stage_offsets(s_off, offsets, d0, dn);
    if (i < n) {
      for (int64_t t = 0; t < dn; ++t) {
        const int64_t o = s_off[t];
        const V* row = data + (d0 + t) * stride;
        // upper (and main) term: A[i, i+o] = val(d, i); the lower bound
        // only keeps a (rejected) negative offset from reading before x
        if (i + o >= 0 && i + o < n) {
          const X v = to_x<X>(row[i]);
          const X* xc = x + p.at(i + o);
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < k) acc[j] += v * xc[j * p.B];
        }
        // mirror term: A[i, i-o] = A[i-o, i] = val(d, i-o)
        if (o > 0 && i >= o) {
          const X v = to_x<X>(row[i - o]);
          const X* xc = x + p.at(i - o);
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < k) acc[j] += v * xc[j * p.B];
        }
      }
    }
  }
  if (i < rows_out) {
    X* yi = y + p.at(i);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) yi[j * p.B] = i < n ? acc[j] : X(0);
  }
}

template <typename V, typename X, int K>
cudaError_t launch_full_k(const void* data, const void* x, const void* offsets,
                          void* y, int64_t D, int64_t stride, int64_t n,
                          int64_t m, int k, Panels px, Panels py,
                          cudaStream_t stream) {
  const int64_t rows_out = py.rows(n);
  dia_spmm_kernel<V, X, K><<<blocks_for(rows_out), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n,
      m, k, px, py, rows_out);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch_full(const void* data, const void* x, const void* offsets,
                        void* y, int64_t D, int64_t stride, int64_t n,
                        int64_t m, int k, Panels px, Panels py,
                        cudaStream_t s) {
  if (k <= 4) return launch_full_k<V, X, 4>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
  if (k <= 8) return launch_full_k<V, X, 8>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
  return launch_full_k<V, X, 16>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
}

template <typename V, typename X, int K>
cudaError_t launch_sym_k(const void* data, const void* x, const void* offsets,
                         void* y, int64_t D, int64_t stride, int64_t n, int k,
                         Panels p, cudaStream_t stream) {
  const int64_t rows_out = p.rows(n);
  dia_sym_spmm_kernel<V, X, K><<<blocks_for(rows_out), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n,
      k, p, rows_out);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch_sym(const void* data, const void* x, const void* offsets,
                       void* y, int64_t D, int64_t stride, int64_t n, int k,
                       Panels p, cudaStream_t s) {
  if (k <= 4) return launch_sym_k<V, X, 4>(data, x, offsets, y, D, stride, n, k, p, s);
  if (k <= 8) return launch_sym_k<V, X, 8>(data, x, offsets, y, D, stride, n, k, p, s);
  return launch_sym_k<V, X, 16>(data, x, offsets, y, D, stride, n, k, p, s);
}

}  // namespace

extern "C" int sigma_dia_spmm(int device, int vtype, int xtype, const void* data,
                              const void* x, const void* offsets, void* y,
                              int64_t D, int64_t stride, int64_t n, int64_t m,
                              int64_t k, int64_t bx, int64_t by, void* stream) {
  Panels px, py;
  if (k < 1 || k > 16 || !make_panels(bx, k, m, &px) || !make_panels(by, k, n, &py))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_full<float, float>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kBF16) return launch_full<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_full<double, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kF32) return launch_full<float, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kBF16) return launch_full<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int sigma_dia_sym_spmm(int device, int vtype, int xtype,
                                  const void* data, const void* x,
                                  const void* offsets, void* y, int64_t D,
                                  int64_t stride, int64_t n, int64_t k,
                                  int64_t b, void* stream) {
  Panels p;
  if (k < 1 || k > 16 || !make_panels(b, k, n, &p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_sym<float, float>(data, x, offsets, y, D, stride, n, kk, p, s);
    if (vtype == kBF16) return launch_sym<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, kk, p, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_sym<double, double>(data, x, offsets, y, D, stride, n, kk, p, s);
    if (vtype == kF32) return launch_sym<float, double>(data, x, offsets, y, D, stride, n, kk, p, s);
    if (vtype == kBF16) return launch_sym<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, kk, p, s);
  }
  return cudaErrorInvalidValue;
}
