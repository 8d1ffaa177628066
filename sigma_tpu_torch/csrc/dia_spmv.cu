// DIA (diagonal-format) sparse matrix-vector products for Hopper (sm_90a).
//
// Four kernels, each a port of a Pallas TPU kernel of the JAX package:
//
//   dia_spmv      replaces sigma_tpu/ops/spmv_pallas.py
//                 dia_spmv_pallas_blocked: y = A x from full-storage DIA,
//                 rectangular n x m.
//   dia_sym_spmv  replaces sigma_tpu/ops/spmv_pallas.py
//                 dia_sym_spmv_pallas_blocked: y = A x from the upper
//                 diagonals (offsets >= 0) of a symmetric matrix.
//   dia_spmv_resident, dia_spmv_window  replace the two bodies of
//                 sigma_tpu/ops/spmv_pallas.py dia_spmv_pallas (the
//                 VMEM-resident x and the manual-DMA x window): the same
//                 y = A x with x read from shared memory (notes below).
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

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

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

// -- staged x: kernels #5 and #6 ---------------------------------------------
//
// The TPU kept x in VMEM so that each diagonal's shifted window came from
// on-chip memory.  Here that memory is a block's shared memory (at most
// 227 KB, opt-in above 48 KB).  The value stream is the same as
// dia_spmv's (each value read once, coalesced); only x's reads move from
// L1/L2 to shared memory, so these kernels are memory bound by the same
// bytes and can at best match dia_spmv.
//
// dia_spmv_resident stages the whole x (m values) once per block and the
// blocks walk the row tiles grid-stride, one block per SM slot, so x is
// read from L2 once per block rather than once per tile.  It takes x of up
// to 57,600 f32 / 28,800 f64 values (ops/spmv_dia.py STAGED_SMEM_BYTES).
//
// dia_spmv_window stages, per tile of T rows starting at row i0, the union
// of the diagonals' x windows [i0 + o, i0 + o + T) as disjoint pieces
// (plan from ops/spmv_dia.py window_plan: piece starts, shared-memory
// bases, each diagonal's base), copied by cp.async (4 or 8 bytes a
// thread, out-of-range columns written as zeros), then computes every
// row of the tile from shared memory.  One window of T + span values, as
// the TPU kernel copied, does not fit for the 3-D stencil (span 93,312 at
// nx=216); the union does (1,200 values for T = 256).

constexpr int kStagedOffsetChunk = 256;  // 2 KB of offsets beside x

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_resident_kernel(const V* __restrict__ data, const X* __restrict__ x,
                             const int64_t* __restrict__ offsets, X* __restrict__ y,
                             int64_t D, int64_t stride, int64_t n, int64_t m) {
  extern __shared__ __align__(16) unsigned char smem[];
  X* s_x = reinterpret_cast<X*>(smem);
  __shared__ int64_t s_off[kStagedOffsetChunk];
  for (int64_t e = threadIdx.x; e < m; e += blockDim.x) s_x[e] = x[e];
  // stage_offsets' first __syncthreads publishes s_x
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t i = tile * kThreads + threadIdx.x;
    X acc = X(0);
    for (int64_t d0 = 0; d0 < D; d0 += kStagedOffsetChunk) {
      const int64_t dn = D - d0 < kStagedOffsetChunk ? D - d0 : kStagedOffsetChunk;
      stage_offsets(s_off, offsets, d0, dn);
      if (i < n) {
        for (int64_t t = 0; t < dn; ++t) {
          const int64_t j = i + s_off[t];
          if (j >= 0 && j < m) acc += to_x<X>(data[(d0 + t) * stride + i]) * s_x[j];
        }
      }
    }
    if (i < n) y[i] = acc;
  }
}

template <typename V, typename X>
__global__ void __launch_bounds__(1024)
    dia_spmv_window_kernel(const V* __restrict__ data, const X* __restrict__ x,
                           const int64_t* __restrict__ offsets, X* __restrict__ y,
                           const int64_t* __restrict__ plan, int64_t D, int64_t stride,
                           int64_t n, int64_t m, int64_t pieces) {
  extern __shared__ __align__(16) unsigned char smem[];
  X* s_x = reinterpret_cast<X*>(smem);
  const int64_t* starts = plan;               // pieces
  const int64_t* bases = plan + pieces;       // pieces + 1
  const int64_t* pos = plan + 2 * pieces + 1;  // D
  const int64_t T = blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * T;
  for (int64_t p = 0; p < pieces; ++p) {
    const int64_t c0 = i0 + starts[p], b = bases[p];
    const int64_t len = bases[p + 1] - b;
    for (int64_t e = threadIdx.x; e < len; e += T) {
      const int64_t c = c0 + e;
      if (c >= 0 && c < m) {
        cp_async(s_x + b + e, x + c);
      } else {
        s_x[b + e] = X(0);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int64_t i = i0 + threadIdx.x;
  if (i >= n) return;
  X acc = X(0);
  for (int64_t d = 0; d < D; ++d) {
    const int64_t j = i + offsets[d];
    if (j >= 0 && j < m) {
      acc += to_x<X>(data[d * stride + i]) * s_x[pos[d] + threadIdx.x];
    }
  }
  y[i] = acc;
}

// Opt a kernel in to `bytes` of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename V, typename X>
cudaError_t launch_resident(const void* data, const void* x, const void* offsets,
                            void* y, int64_t D, int64_t stride, int64_t n, int64_t m,
                            cudaStream_t stream) {
  auto kernel = dia_spmv_resident_kernel<V, X>;
  const size_t bytes = static_cast<size_t>(m) * sizeof(X);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;  // x does not fit
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const int64_t slots = static_cast<int64_t>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch_window(const void* data, const void* x, const void* offsets, void* y,
                          int64_t D, int64_t stride, int64_t n, int64_t m,
                          const void* plan, int64_t pieces, int64_t tile_rows,
                          int64_t length, cudaStream_t stream) {
  if (tile_rows < 32 || tile_rows > 1024 || tile_rows % 32) return cudaErrorInvalidValue;
  auto kernel = dia_spmv_window_kernel<V, X>;
  const size_t bytes = static_cast<size_t>(length) * sizeof(X);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + tile_rows - 1) / tile_rows);
  kernel<<<grid, static_cast<unsigned>(tile_rows), bytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y),
      static_cast<const int64_t*>(plan), D, stride, n, m, pieces);
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

extern "C" int sigma_dia_spmv_resident(int device, int vtype, int xtype, const void* data,
                                       const void* x, const void* offsets, void* y,
                                       int64_t D, int64_t stride, int64_t n, int64_t m,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_resident<float, float>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kBF16) return launch_resident<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, m, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_resident<double, double>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kF32) return launch_resident<float, double>(data, x, offsets, y, D, stride, n, m, s);
    if (vtype == kBF16) return launch_resident<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, m, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int sigma_dia_spmv_window(int device, int vtype, int xtype, const void* data,
                                     const void* x, const void* offsets, void* y,
                                     int64_t D, int64_t stride, int64_t n, int64_t m,
                                     const void* plan, int64_t pieces, int64_t tile_rows,
                                     int64_t length, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xtype == kF32) {
    if (vtype == kF32) return launch_window<float, float>(data, x, offsets, y, D, stride, n, m, plan, pieces, tile_rows, length, s);
    if (vtype == kBF16) return launch_window<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, m, plan, pieces, tile_rows, length, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch_window<double, double>(data, x, offsets, y, D, stride, n, m, plan, pieces, tile_rows, length, s);
    if (vtype == kF32) return launch_window<float, double>(data, x, offsets, y, D, stride, n, m, plan, pieces, tile_rows, length, s);
    if (vtype == kBF16) return launch_window<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, m, plan, pieces, tile_rows, length, s);
  }
  return cudaErrorInvalidValue;
}
