// Pruned block-DIA sparse products for Hopper (sm_90a): y = A x and
// Y = A X (1 <= k <= 16 panels) over the packed active (row tile x
// diagonal) slots of an RCM-banded unstructured matrix.
//
// Four kernels, each a port of a Pallas TPU kernel of the JAX package
// (sigma_tpu/ops/spmv_pruned.py):
//
//   pruned_spmv      replaces dia_spmv_pallas_pruned: y = A x.
//   pruned_spmm      replaces dia_spmm_pruned_rhs_major: Y = A X, the
//                    packed values read once for all k panels.
//   pruned_sym_spmv  replaces dia_sym_spmv_pallas_pruned: y = A x from the
//                    slots with offset >= sym_shift (upper triangle and
//                    main diagonal) and their mirror; the mirror terms on
//                    rows n .. n + spill_rows come back as the spill.
//   pruned_sym_spmm  replaces dia_sym_spmm_pruned_rhs_major: the same for
//                    k panels, with a (k, spill_rows) spill.
//
// Layout (ops/spmv_pruned.py).  data is (n_slots, TR) row-major: slot s
// holds the TR values of one (tile t, offset o) pair, data[s*TR + r] =
// A[t*TR + r, t*TR + r + o].  offsets[s] is o; the slots of tile t are
// tile_ptr[t] .. tile_ptr[t+1] (in offset order, padded with zero slots of
// offset 0 to a multiple of the group).  TR is a multiple of 1024, so a
// block of 256 rows lies in one tile.  The TPU kernel's flat grid carried
// a tile's sum across its steps in VMEM and needed a haloed x frame, window
// rolls and first-step flags; here a block owns its rows outright and
// walks its tile's slot list, so nothing carries between blocks.
//
// Design.  One thread per output row, as the DIA kernels (dia_spmv.cu):
// the block stages its tile's slot offsets in shared memory (in chunks)
// and every thread walks the same list, so there is no divergence, and
// neighbouring threads read neighbouring values of each slot stripe and
// neighbouring x[i + o]: both streams coalesce.  The sum runs in slot
// order, the JAX kernel's per-row order up to its grouping by C.  The
// multi-RHS kernels multiply each value, loaded once, into K in
// {1, 4, 8, 16} register accumulators (runtime k <= K, touched only in
// unrolled loops under j < k).  The slot loop is not unrolled: measured
// with ptxas -v on sm_90a, unrolling it 2 to 16 times spills 40-284 bytes
// over the 40 instantiations (and the compiler's own choice 4 bytes in
// one), not unrolling it spills none at 28-74 registers.  Panels are
// addressed with the panel-block length B of dia_spmm.cu (B = length:
// RHS-major (k, len); B = 1: columns (len, k)).
//
// Symmetric storage.  The mirror term of row i is
//     A[i, i - om] = d_s[i - om]  times  x[i - om + sym_shift]
// for every slot s with mirror offset om = offsets[s] - sym_shift > 0
// whose source row i - om lies in s's tile.  The plan widens the tile
// until the band's reach fits one tile (om < TR), so the source row lies
// in the row's own tile t or in t - 1: row i walks tile t's slots (upper
// and mirror terms) and tile t - 1's slots (mirror terms with
// om > i - t*TR; a block skips tile t - 1 when its first row is at least
// spill_rows = halo*128 > om past the tile start).  This is a gather: no
// atomics, and the result does not depend on the blocks' schedule.  The
// TPU kernel instead scattered each tile's mirror into a per-tile spill
// block that an XLA pass added to the next tile.  Rows n .. n + spill_rows
// are launched too when a spill is asked for and take the mirror terms
// only.
//
// What bounds them.  Memory: the packed values once, x and y once.  At
// the 10M-row north star (10,092,544 rows, 70.0M nonzeros, RCM bandwidth
// 122, tile 16384) the full-storage plan packs 1.67 GB of f32 values, so
// #10's floor is 1.67 GB + 40 MB x + 40 MB y = 1.75 GB, 0.59 ms at the
// ~2.95 TB/s copy rate measured on the H100; #11 at k=8 reads the values
// once and 8 x- and 8 y-panels, 1.67 + 8 x 0.08 = 2.31 GB, 0.78 ms.  The
// symmetric plan packs 0.98 GB, so #12's floor is about 1.06 GB, 0.36 ms.
// The symmetric kernels read each value twice (upper term at row i,
// mirror term at row i + om); the second read is at most one tile later
// (om < TR) while about four tiles of blocks are in flight, so it hits
// the 50 MB L2 and the values come from device memory about once: the
// argument of dia_spmv.cu's symmetric kernel.  The zero padding slots are
// read too (the group padding of the TPU layout).
//
// Masking.  Out-of-range terms (column outside [0, m)) are skipped, never
// multiplied by zero; a padding slot multiplies its zero values by x[i]
// as the TPU kernel and the JAX package's reference do.  Accumulation is
// in the vector type X; the five (value, vector) dtype pairs of the DIA
// kernels; all index arithmetic is 64-bit (the 10M plan holds about
// 4.2e8 values and k panels multiply that).
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k, a
// panel-block length or a tile height it does not take.

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

template <typename X, int K>
__device__ __forceinline__ void fma_panels(X (&acc)[K], X v, const X* xc,
                                           int64_t B, int k) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < k) acc[j] += v * xc[j * B];
}

template <typename V, typename X, int K>
__global__ void __launch_bounds__(kThreads)
    pruned_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ tile_ptr, X* __restrict__ y,
                       int64_t TR, int64_t n, int64_t m, int k, Panels px,
                       Panels py) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t i = row0 + threadIdx.x;
  const int64_t t = row0 / TR;  // the block's tile
  const int64_t r = i - t * TR;
  const int64_t s0 = tile_ptr[t], s1 = tile_ptr[t + 1];
  X acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = X(0);
  for (int64_t c0 = s0; c0 < s1; c0 += kOffsetChunk) {
    const int64_t cn = s1 - c0 < kOffsetChunk ? s1 - c0 : kOffsetChunk;
    stage_offsets(s_off, offsets, c0, cn);
    if (i < n) {
#pragma unroll 1
      for (int64_t c = 0; c < cn; ++c) {
        const int64_t col = i + s_off[c];
        if (col >= 0 && col < m)
          fma_panels<X, K>(acc, to_x<X>(data[(c0 + c) * TR + r]), x + px.at(col), px.B, k);
      }
    }
  }
  if (i < n) {
    X* yi = y + py.at(i);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) yi[j * py.B] = acc[j];
  }
}

template <typename V, typename X, int K>
__global__ void __launch_bounds__(kThreads)
    pruned_sym_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                           const int64_t* __restrict__ offsets,
                           const int64_t* __restrict__ tile_ptr,
                           X* __restrict__ y, X* __restrict__ spill, int64_t TR,
                           int64_t G, int64_t n, int64_t m, int k, Panels px,
                           Panels py, Panels ps, int64_t sym_shift,
                           int64_t spill_rows, int64_t rows_out) {
  __shared__ int64_t s_off[kOffsetChunk];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t i = row0 + threadIdx.x;
  const int64_t t = row0 / TR;  // the block's tile (G for spill rows past the last)
  const int64_t r = i - t * TR;
  X acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = X(0);
  if (t < G) {
    // the row's own tile: upper terms (rows < n) and mirror terms whose
    // source row i - om lies in this tile (om <= r)
    const int64_t s0 = tile_ptr[t], s1 = tile_ptr[t + 1];
    for (int64_t c0 = s0; c0 < s1; c0 += kOffsetChunk) {
      const int64_t cn = s1 - c0 < kOffsetChunk ? s1 - c0 : kOffsetChunk;
      stage_offsets(s_off, offsets, c0, cn);
      if (i < rows_out) {
#pragma unroll 1
        for (int64_t c = 0; c < cn; ++c) {
          const int64_t o = s_off[c];
          const V* d = data + (c0 + c) * TR;
          const int64_t col = i + o;
          if (i < n && col >= 0 && col < m)
            fma_panels<X, K>(acc, to_x<X>(d[r]), x + px.at(col), px.B, k);
          const int64_t om = o - sym_shift;
          const int64_t src = i - om + sym_shift;
          if (om > 0 && om <= r && src >= 0 && src < m)
            fma_panels<X, K>(acc, to_x<X>(d[r - om]), x + px.at(src), px.B, k);
        }
      }
    }
  }
  if (t >= 1 && t - 1 < G && row0 - t * TR < spill_rows) {
    // the tile before: mirror terms whose source row lies there (om > r)
    const int64_t s0 = tile_ptr[t - 1], s1 = tile_ptr[t];
    for (int64_t c0 = s0; c0 < s1; c0 += kOffsetChunk) {
      const int64_t cn = s1 - c0 < kOffsetChunk ? s1 - c0 : kOffsetChunk;
      stage_offsets(s_off, offsets, c0, cn);
      if (i < rows_out) {
#pragma unroll 1
        for (int64_t c = 0; c < cn; ++c) {
          const int64_t om = s_off[c] - sym_shift;
          const int64_t src = i - om + sym_shift;
          if (om > r && src >= 0 && src < m)
            fma_panels<X, K>(acc, to_x<X>(data[(c0 + c) * TR + TR + r - om]),
                             x + px.at(src), px.B, k);
        }
      }
    }
  }
  if (i < rows_out) {
    X* yi = i < n ? y + py.at(i) : spill + ps.at(i - n);
    const int64_t B = i < n ? py.B : ps.B;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) yi[j * B] = acc[j];
  }
}

template <typename V, typename X, int K>
cudaError_t launch_full_k(const void* data, const void* x, const void* offsets,
                          const void* tile_ptr, void* y, int64_t TR, int64_t n,
                          int64_t m, int k, Panels px, Panels py,
                          cudaStream_t stream) {
  pruned_spmm_kernel<V, X, K><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(tile_ptr),
      static_cast<X*>(y), TR, n, m, k, px, py);
  return cudaGetLastError();
}

template <typename V, typename X, int K>
cudaError_t launch_sym_k(const void* data, const void* x, const void* offsets,
                         const void* tile_ptr, void* y, void* spill, int64_t TR,
                         int64_t G, int64_t n, int64_t m, int k, Panels px,
                         Panels py, Panels ps, int64_t sym_shift,
                         int64_t spill_rows, int64_t rows_out,
                         cudaStream_t stream) {
  pruned_sym_spmm_kernel<V, X, K><<<blocks_for(rows_out), kThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(tile_ptr),
      static_cast<X*>(y), static_cast<X*>(spill), TR, G, n, m, k, px, py, ps,
      sym_shift, spill_rows, rows_out);
  return cudaGetLastError();
}

// The dtype dispatch: returns CALL with V and X the instantiated (value,
// vector) pair, else cudaErrorInvalidValue.
#define PRUNED_DISPATCH(vtype, xtype, CALL)                                   \
  do {                                                                        \
    if (xtype == kF32 && vtype == kF32) { using V = float; using X = float; return CALL; } \
    if (xtype == kF32 && vtype == kBF16) { using V = __nv_bfloat16; using X = float; return CALL; } \
    if (xtype == kF64 && vtype == kF64) { using V = double; using X = double; return CALL; } \
    if (xtype == kF64 && vtype == kF32) { using V = float; using X = double; return CALL; } \
    if (xtype == kF64 && vtype == kBF16) { using V = __nv_bfloat16; using X = double; return CALL; } \
    return cudaErrorInvalidValue;                                             \
  } while (0)

// The K bound of a panel count: the smallest of {4, 8, 16} that holds k.
#define PRUNED_BY_K(kk, LAUNCH) \
  ((kk) <= 4 ? LAUNCH(4) : (kk) <= 8 ? LAUNCH(8) : LAUNCH(16))

// Checks shared by the entry points; false for what the kernels do not take.
bool valid(int64_t TR, int64_t G, int64_t n, int64_t k) {
  return TR > 0 && TR % 1024 == 0 && G >= 1 && n <= G * TR && k >= 1 && k <= 16;
}

}  // namespace

extern "C" int sigma_pruned_spmv(int device, int vtype, int xtype,
                                 const void* data, const void* x,
                                 const void* offsets, const void* tile_ptr,
                                 void* y, int64_t TR, int64_t G, int64_t n,
                                 int64_t m, void* stream) {
  if (!valid(TR, G, n, 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Panels p{1, 1, 0};  // one panel: element i at i
  PRUNED_DISPATCH(vtype, xtype, (launch_full_k<V, X, 1>(
      data, x, offsets, tile_ptr, y, TR, n, m, 1, p, p, s)));
}

extern "C" int sigma_pruned_spmm(int device, int vtype, int xtype,
                                 const void* data, const void* x,
                                 const void* offsets, const void* tile_ptr,
                                 void* y, int64_t TR, int64_t G, int64_t n,
                                 int64_t m, int64_t k, int64_t bx, int64_t by,
                                 void* stream) {
  Panels px, py;
  if (!valid(TR, G, n, k) || !make_panels(bx, k, m, &px) || !make_panels(by, k, n, &py))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
#define LAUNCH(K) launch_full_k<V, X, K>(data, x, offsets, tile_ptr, y, TR, n, m, kk, px, py, s)
  PRUNED_DISPATCH(vtype, xtype, PRUNED_BY_K(kk, LAUNCH));
#undef LAUNCH
}

extern "C" int sigma_pruned_sym_spmv(int device, int vtype, int xtype,
                                     const void* data, const void* x,
                                     const void* offsets, const void* tile_ptr,
                                     void* y, void* spill, int64_t TR, int64_t G,
                                     int64_t n, int64_t m, int64_t sym_shift,
                                     int64_t spill_rows, int64_t rows_out,
                                     void* stream) {
  if (!valid(TR, G, n, 1) || spill_rows > TR || rows_out < n ||
      rows_out > n + spill_rows || (rows_out > n && spill == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Panels p{1, 1, 0};  // one panel: element i at i
  PRUNED_DISPATCH(vtype, xtype, (launch_sym_k<V, X, 1>(
      data, x, offsets, tile_ptr, y, spill, TR, G, n, m, 1, p, p, p, sym_shift,
      spill_rows, rows_out, s)));
}

extern "C" int sigma_pruned_sym_spmm(int device, int vtype, int xtype,
                                     const void* data, const void* x,
                                     const void* offsets, const void* tile_ptr,
                                     void* y, void* spill, int64_t TR, int64_t G,
                                     int64_t n, int64_t m, int64_t k, int64_t bx,
                                     int64_t by, int64_t bs, int64_t sym_shift,
                                     int64_t spill_rows, int64_t rows_out,
                                     void* stream) {
  Panels px, py, ps;
  if (!valid(TR, G, n, k) || spill_rows > TR || rows_out < n ||
      rows_out > n + spill_rows || (rows_out > n && spill == nullptr) ||
      !make_panels(bx, k, m, &px) || !make_panels(by, k, n, &py) ||
      !make_panels(bs, k, spill_rows, &ps))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
#define LAUNCH(K)                                                                 \
  launch_sym_k<V, X, K>(data, x, offsets, tile_ptr, y, spill, TR, G, n, m, kk, px, \
                        py, ps, sym_shift, spill_rows, rows_out, s)
  PRUNED_DISPATCH(vtype, xtype, PRUNED_BY_K(kk, LAUNCH));
#undef LAUNCH
}
