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
// What bounds them.  Memory: each stored value is read once for all k
// right-hand sides.  The byte floor of one product is the stored values
// once plus k x-panels and k y-panels: for the f32 7-point stencil at
// nx=216 (10,077,696 rows) and k = 8, 281 + 322 + 322 MB; for the
// 10.1M-row mesh's RCM band (245 diagonals) 9.89 + 0.32 + 0.32 GB.  Every
// FMA needs its x operand from on-chip memory, so the x stream must cost
// no more than about a byte of shared-memory read per FMA while the value
// stream runs underneath at the copy rate.
//
// dia_spmm is the staged-window design of dia_window.cuh (shared with
// dia_spmm_grouped.cu): a register tile of 4 rows x C columns a thread (C =
// 8 with f32 vectors, 4 with f64), G = ceil(k / C) threads on a row group,
// so a block of 256 threads covers all k columns of 1024 / G rows and no
// thread computes only zeros; the block's x window staged once per run of
// diagonals (16-byte pieces where the layout allows: 4 consecutive rows of
// a panel, or a row of (m, k) columns); the values through a 3-stage
// cp.async ring of 16 KB stages; x carried along the band in the tile.  A
// stencil's far offsets (+-nx^2) are runs of their own: from panels, whose
// 4 rows of a column are one coalesced piece, each is loaded straight into
// the tile; from (m, k) columns each is staged as a window.
// The result is stored in 16-byte pieces where y's layout allows; the
// block that owns the interleaved layout's padding rows writes their zeros.
//
// dia_sym_spmm is the first version: one thread per output row, offsets
// staged in shared memory in chunks, each value loaded once and multiplied
// into k accumulators held in registers (a compile-time bound K in {4, 8,
// 16}, indexed only inside fully unrolled loops guarded by j < k).  It adds
// the mirror term val(d, i - o) * X(j, i - o) for o > 0, a second
// coalesced value stream shifted back by o rows; only 4 x 46,656 f32
// values (746 KB) plus 8 panels' windows stream between a value line's two
// reads, so the second read hits L2 and the values still come from device
// memory about once.
//
// Masking, types, indexing: out-of-range terms are selected away, never
// multiplied by zero (NaN * 0 is NaN); accumulation is in the vector type,
// each row's terms in ascending diagonal order, one FMA each; the five
// (value, vector) dtype pairs of the SpMV kernels; all index arithmetic on
// rows and slots is 64-bit; any value stride and alignment.
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k or a
// panel-block length it does not take.  sigma_dia_spmm_config reports the
// launch shape dia_spmm takes for a dtype pair and k.

#include "dia_window.cuh"

namespace {

using namespace sigma_dia;

// dia_spmm's block shape for G column groups: 16 KB ring stages, 3 ring
// buffers, 110 KB of shared memory (two blocks an SM), or 200 KB where the
// registers allow one block an SM (f64 values with f64 vectors); 8 panel
// pieces in flight a thread while the window is staged (at 12 ptxas
// spilled)
template <typename V, typename X, int G>
using FullShape =
    WindowShape<V, X, G, 16 * 1024, 3, (sizeof(V) == 8 && sizeof(X) == 8 ? 200 : 110) * 1024, 8>;

template <typename V, typename X, int G>
__global__ void __launch_bounds__(kBlockThreads, (FullShape<V, X, G>::kMinBlocks))
    dia_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                    const int64_t* __restrict__ offsets, X* __restrict__ y, int64_t D,
                    int64_t stride, int64_t n, int64_t m, int k, Panels px, Panels py,
                    int64_t rows_out, int route, bool v_pieces, bool direct) {
  using S = FullShape<V, X, G>;
  window_spmm_block<S>(data, x, offsets, y, D, stride, n, m, k, px, py, rows_out,
                       static_cast<int64_t>(blockIdx.x) * S::kRows, 0, route, v_pieces, direct);
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

template <typename V, typename X, int G>
cudaError_t launch_full_g(const void* data, const void* x, const void* offsets, void* y,
                          int64_t D, int64_t stride, int64_t n, int64_t m, int k, Panels px,
                          Panels py, cudaStream_t stream) {
  using S = FullShape<V, X, G>;
  const int64_t rows_out = py.rows(n);
  const int64_t blocks = (rows_out + S::kRows - 1) / S::kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  auto kernel = dia_spmm_kernel<V, X, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  // 16-byte value copies where every value row is 16-byte aligned
  const bool v_pieces = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                        stride % (16 / static_cast<int64_t>(sizeof(V))) == 0;
  const int route = pick_route<S>(x, k, px);
  // runs of one diagonal straight into the tile from panels (the faster
  // route there on the stencil); through the window from (m, k) columns
  const bool direct = route == kPanelPieces || route == kPanelValues;
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, S::kSmemBytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m, k, px, py,
      rows_out, route, v_pieces, direct);
  return cudaGetLastError();
}

// G: the fewest column groups whose tiles cover k (C columns a thread)
template <typename V, typename X>
cudaError_t launch_full(const void* data, const void* x, const void* offsets, void* y,
                        int64_t D, int64_t stride, int64_t n, int64_t m, int k, Panels px,
                        Panels py, cudaStream_t s) {
  constexpr int C = sizeof(X) == 8 ? 4 : 8;
  if (k <= C) return launch_full_g<V, X, 1>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
  if (k <= 2 * C) return launch_full_g<V, X, 2>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
  if constexpr (sizeof(X) == 8) {
    if (k <= 4 * C) return launch_full_g<V, X, 4>(data, x, offsets, y, D, stride, n, m, k, px, py, s);
  }
  return cudaErrorInvalidValue;
}

template <typename V, typename X, int G>
void full_config(int64_t* out) {
  using S = FullShape<V, X, G>;
  out[0] = S::kSmemBytes;
  out[1] = S::kWindowRows;
  out[2] = S::kDiags;
  out[3] = S::kStages;
  out[4] = S::kCols;
  out[5] = S::kMinBlocks;
  out[6] = S::kRows;
}

template <typename V, typename X>
int full_config_k(int64_t k, int64_t* out) {
  constexpr int C = sizeof(X) == 8 ? 4 : 8;
  if (k < 1 || k > 16) return cudaErrorInvalidValue;
  if (k <= C) return full_config<V, X, 1>(out), 0;
  if (k <= 2 * C) return full_config<V, X, 2>(out), 0;
  if constexpr (sizeof(X) == 8) return full_config<V, X, 4>(out), 0;
  return cudaErrorInvalidValue;
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

// dia_spmm's launch shape for a dtype pair and k: out[0..6] = dynamic
// shared memory bytes a block, window rows, diagonals a ring stage, ring
// stages, columns a block, the blocks an SM its register bound allows, and
// rows a block.  Returns cudaErrorInvalidValue for a dtype pair or k it
// does not take.
extern "C" int sigma_dia_spmm_config(int vtype, int xtype, int64_t k, int64_t* out) {
  if (xtype == kF32 && vtype == kF32) return full_config_k<float, float>(k, out);
  if (xtype == kF32 && vtype == kBF16) return full_config_k<__nv_bfloat16, float>(k, out);
  if (xtype == kF64 && vtype == kF64) return full_config_k<double, double>(k, out);
  if (xtype == kF64 && vtype == kF32) return full_config_k<float, double>(k, out);
  if (xtype == kF64 && vtype == kBF16) return full_config_k<__nv_bfloat16, double>(k, out);
  return cudaErrorInvalidValue;
}
