// Grouped block-sparse-row SpMV / SpMM for Hopper (sm_90a).
//
// bsr_grouped_spmv replaces sigma_tpu/ops/bsr_pallas.py bsr_grouped_spmv:
// Y = A X for a block-CSR matrix in the grouped layout.  Group g holds B
// value blocks of (bh, bw) side by side, gdata[g] = (bh, B*bw) row-major,
// the block-column index of each in gcols[g, 0..B), and belongs to block
// row grow[g]; a block row's groups are a contiguous run (grow ascends).
// X is (nb_cols*bw, k) row-major, Y (nb_rows*bh, k).  Output row h of
// block row r is
//
//   Y[r*bh + h, :] = sum over groups g of r, columns c in [0, B*bw):
//                    gdata[g, h, c] * X[gcols[g, c / bw]*bw + c % bw, :]
//
// What differs from the TPU kernel.  That kernel visits one group per grid
// step, in order, gathers the B x blocks by scalar-prefetched index maps
// and revisits the output block, overwriting on a row's first group and
// adding on the later ones.  Blocks of a CUDA grid run in no order, so
// here an output row belongs to one sub-group of L lanes of a warp, which
// walks the row's run of groups from a group pointer (gptr[r] ..
// gptr[r+1], made once from grow), and writes Y once: no atomics, no
// zero-fill pass, no first-group flag, and a summation order that is fixed
// by the shapes alone (each lane sums its columns c = lane, lane + L, ...
// in order, then the L partial sums fold in a butterfly).  The index
// arrays are read from device memory, so their size is not limited (the
// TPU kernel's arrays had to fit its scalar memory).
//
// Shapes are runtime values.  L (a power of two, 1..32) is picked by the
// wrapper from the group's width B*bw: 8 for (8, 128) blocks in groups of
// 8 (a 1,024-long dot product per output row and group, 128 columns per
// lane), 1 for (3, 3) blocks in groups of 8 (24 columns: one thread per
// output row, no reduction).  Lanes of a sub-group read neighbouring
// addresses of one gdata row; sub-groups of a warp take neighbouring
// output rows, whose gdata rows are neighbours in memory too, so every
// byte of a fetched line is used, if over several steps out of L1.  The bh
// output rows of a block row gather the same x blocks; they sit in the
// same or the next warp, so the repeats hit in L1 or L2.
//
// What bounds it.  Memory: every stored value is read once and used for
// 2k operations (k <= 8: 0.5 to 4 FLOP per byte of f32 values, far under
// the card's ~20 FLOP/byte).  The floor is gdata + gcols + gptr + x + y
// bytes; the gathered x (G*B*bw*k values) is the traffic to keep in cache.
// Up to kMaxK = 8 columns are held in registers per pass; more columns run
// as further passes over gdata (grid.y), each reading the values again.
// All loads are scalar: a (3, 3) block's rows are 12 bytes and nothing is
// 16-byte aligned, so vector loads wait for a layout that pads or
// transposes the small blocks.
//
// Types.  Values are cast up to the vector type and accumulated there with
// exact fused multiply-adds (no TF32 for f32: the TPU kernel ran its
// product at HIGHEST precision): (f32, f32), (bf16, f32), (f64, f64),
// (f32, f64), (bf16, f64).  bf16 vectors, which the TPU kernel also took,
// are widened to f32, accumulated in f32 and rounded once on the store:
// (bf16, bf16), (f32, bf16).  Index arithmetic is 64-bit: the 10.1M-dof
// elasticity operator stores 243M values and a 2 GB block-banded operator
// 537M.
//
// Interface.  One plain C entry point bound with ctypes; it launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype pair or a lane
// count it does not take).

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

constexpr int kMaxK = 8;

// the accumulator type of a vector type: bf16 vectors accumulate in f32
template <typename X> struct Acc { using type = X; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

template <typename X, typename A>
__device__ __forceinline__ X from_acc(A v) {
  return static_cast<X>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename V, typename X, int KT>
__global__ void __launch_bounds__(kThreads)
    bsr_grouped_kernel(const V* __restrict__ gdata, const int32_t* __restrict__ gcols,
                       const int64_t* __restrict__ gptr, const X* __restrict__ x,
                       X* __restrict__ y, int64_t n_rows, int bh, int bw, int B,
                       int64_t k, int lanes, int lane_shift) {
  using A = typename Acc<X>::type;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lane_shift;  // output row r*bh + h
  const int lane = static_cast<int>(tid & (lanes - 1));
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * KT;
  const int kn = k - k0 < KT ? static_cast<int>(k - k0) : KT;
  const bool live = row < n_rows;  // idle lanes still take part in the shuffles
  A acc[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) acc[q] = A(0);
  if (live) {
    const int64_t r = row / bh;
    const int64_t h = row - r * bh;
    const int width = B * bw;
    const int64_t g_end = gptr[r + 1];
    for (int64_t g = gptr[r]; g < g_end; ++g) {
      const V* vals = gdata + (g * bh + h) * width;
      const int32_t* cols = gcols + g * B;
      int j = lane / bw;       // block of this lane's column within the group
      int cc = lane - j * bw;  // column within that block
      for (int c = lane; c < width; c += lanes) {
        const A v = to_x<A>(vals[c]);
        const X* xr = x + (static_cast<int64_t>(cols[j]) * bw + cc) * k + k0;
#pragma unroll
        for (int q = 0; q < KT; ++q)
          if (q < kn) acc[q] += v * to_x<A>(xr[q]);
        cc += lanes;
        while (cc >= bw) {
          cc -= bw;
          ++j;
        }
      }
    }
  }
  for (int s = lanes >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], s);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int q = 0; q < KT; ++q)
      if (q < kn) y[row * k + k0 + q] = from_acc<X, A>(acc[q]);
  }
}

template <typename V, typename X, int KT>
cudaError_t launch_kt(const void* gdata, const void* gcols, const void* gptr,
                      const void* x, void* y, int64_t n_rows, int bh, int bw, int B,
                      int64_t k, int lanes, int lane_shift, cudaStream_t stream) {
  const int64_t threads = n_rows * lanes;
  const dim3 grid(blocks_for(threads), static_cast<unsigned>((k + KT - 1) / KT));
  bsr_grouped_kernel<V, X, KT><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(gdata), static_cast<const int32_t*>(gcols),
      static_cast<const int64_t*>(gptr), static_cast<const X*>(x),
      static_cast<X*>(y), n_rows, bh, bw, B, k, lanes, lane_shift);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch(const void* gdata, const void* gcols, const void* gptr,
                   const void* x, void* y, int64_t n_rows, int bh, int bw, int B,
                   int64_t k, int lanes, int lane_shift, cudaStream_t s) {
  if (k == 1)
    return launch_kt<V, X, 1>(gdata, gcols, gptr, x, y, n_rows, bh, bw, B, k, lanes, lane_shift, s);
  if (k == 2)
    return launch_kt<V, X, 2>(gdata, gcols, gptr, x, y, n_rows, bh, bw, B, k, lanes, lane_shift, s);
  if (k <= 4)
    return launch_kt<V, X, 4>(gdata, gcols, gptr, x, y, n_rows, bh, bw, B, k, lanes, lane_shift, s);
  return launch_kt<V, X, kMaxK>(gdata, gcols, gptr, x, y, n_rows, bh, bw, B, k, lanes, lane_shift, s);
}

}  // namespace

// (device, value type, vector type, gdata (G, bh, B*bw), gcols (G, B) int32,
//  gptr (nb_rows + 1) int64, x (nb_cols*bw, k), y (nb_rows*bh, k),
//  nb_rows, bh, bw, B, k, lanes per output row, stream)
extern "C" int sigma_bsr_grouped_spmv(int device, int vtype, int xtype,
                                      const void* gdata, const void* gcols,
                                      const void* gptr, const void* x, void* y,
                                      int64_t nb_rows, int64_t bh, int64_t bw,
                                      int64_t B, int64_t k, int64_t lanes,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return cudaErrorInvalidValue;
  if (bh < 1 || bw < 1 || B < 1 || k < 1 || B * bw > INT32_MAX) return cudaErrorInvalidValue;
  int shift = 0;
  while ((int64_t(1) << shift) < lanes) ++shift;
  const int64_t n_rows = nb_rows * bh;
  const int ibh = static_cast<int>(bh), ibw = static_cast<int>(bw), iB = static_cast<int>(B);
  const int il = static_cast<int>(lanes);
#define SIGMA_BSR_CASE(VC, XC, V, X)                                              \
  if (vtype == VC && xtype == XC)                                                 \
    return launch<V, X>(gdata, gcols, gptr, x, y, n_rows, ibh, ibw, iB, k, il, shift, s);
  SIGMA_BSR_CASE(kF32, kF32, float, float)
  SIGMA_BSR_CASE(kBF16, kF32, __nv_bfloat16, float)
  SIGMA_BSR_CASE(kF64, kF64, double, double)
  SIGMA_BSR_CASE(kF32, kF64, float, double)
  SIGMA_BSR_CASE(kBF16, kF64, __nv_bfloat16, double)
  SIGMA_BSR_CASE(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
  SIGMA_BSR_CASE(kF32, kBF16, float, __nv_bfloat16)
#undef SIGMA_BSR_CASE
  return cudaErrorInvalidValue;
}
