// Grouped block-sparse-row SpMV / SpMM for Hopper (sm_90a).
//
// bsr_grouped_spmv replaces sigma_tpu/ops/bsr_pallas.py bsr_grouped_spmv:
// Y = A X for a block-CSR matrix in the grouped layout.  Group g holds B
// value blocks of (bh, bw) side by side, gdata[g] = (bh, W = B*bw)
// row-major, the block-column index of each in gcols[g, 0..B), and belongs
// to block row grow[g]; a block row's groups are a contiguous run (grow
// ascends).  X is (nb_cols*bw, k) row-major, Y (nb_rows*bh, k).  Output
// row h of block row r is
//
//   Y[r*bh + h, :] = sum over groups g of r, columns c in [0, W):
//                    gdata[g, h, c] * X[gcols[g, c / bw]*bw + c % bw, :]
//
// What differs from the TPU kernel.  That kernel visits one group per grid
// step, in order, gathers the B x blocks by scalar-prefetched index maps
// and revisits the output block, overwriting on a row's first group and
// adding on the later ones.  Blocks of a CUDA grid run in no order, so
// here a block row's run of groups (gptr[r] .. gptr[r+1], made once from
// grow) is walked by one warp or one thread per output row, which writes Y
// once: no atomics, no zero-fill pass, no first-group flag, and a
// summation order fixed by the shapes alone.  The index arrays are read
// from device memory, so their size is not limited (the TPU kernel's had
// to fit its scalar memory).
//
// What bounds it.  Memory: every stored value is read once and used for
// 2k operations (0.5 to 4 FLOP per byte of f32 values at k <= 8, far
// under the card's ~20 FLOP/byte).  The floor is gdata + gcols + gptr + x
// + y bytes.  Device memory keeps ~25 KB of loads in flight per SM only
// when each thread has several 16-byte loads outstanding, so values are
// read in 16-byte pieces wherever a group row allows it, and a wide lane
// issues the pieces of all its rows at once.  The wide form reads values
// with the streaming hint (each is used once), so that x, which is
// gathered many times, stays in L2.  The narrow form may not: its lanes'
// pieces lie a group row apart, so each 32-byte sector serves two of a
// lane's loads, and an evict-first line was gone by the second (2.5x
// slower on the elasticity operator, measured).
//
// Two forms, picked by the wrapper from the shape and the value dtype
// (ops/bsr_grouped.py bsr_grouped_form):
//
// * wide (a group row of at least 32 pieces, bw a multiple of the piece,
//   e.g. (8, 128) blocks in groups of 8: 1,024 columns).  One warp per
//   block row.  Lane l owns the pieces at columns P*l + 32*P*t of every
//   group (P values a 16-byte piece): for each piece it loads the P x rows
//   once (contiguous, since bw is a multiple of P) and runs up to kRows
//   output rows of values through them, kept as raw 16-byte words (4
//   registers a row whatever the value type).  x is so gathered once per
//   group and reused across its rows, from registers; block rows of more
//   than kRows rows take further passes.  After the row's last group a
//   butterfly folds the sums across the warp and one lane stores each
//   output value.  The piece loop is not unrolled: its registers buy two
//   blocks an SM, which measured faster than two pieces in flight.
// * narrow (e.g. (3, 3) blocks in groups of 8: 24 columns, 96 bytes of f32
//   values a group row).  One thread per output row reads its group row in
//   16-byte pieces (a group row of 16-byte multiple width starts on a
//   16-byte boundary even where a block row does not) and gathers x value
//   by value through gcols; the bh threads of a block row read the same x
//   addresses.  A group row that is not a multiple of 16 bytes wide, or
//   gdata that does not start on a 16-byte boundary, is read one value at
//   a time by the same code (P = 1): (3, 3) blocks in groups of 1, (4, 4)
//   bf16 blocks in groups of 1, odd bw with bf16 values.
//
// Columns of x: a pass takes up to KT (1, 2, 4 or 8) columns; more run as
// further passes over gdata (grid.y), each reading the values again.
// Passes rather than x staged in shared memory: the main paths run k <= 8.
// A wide lane holds kRows x kLaneCols sums (32 registers), so a pass of
// more columns splits the warp's lanes between them: at k = 8 in f32 two
// groups of 16 lanes, each over the whole group row, the two lanes that
// share a value piece reading it in one transaction.  x is read in 16- or
// 8-byte words where its rows allow it.
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
// caller's stream, does not synchronise, allocates nothing, sets the device
// only when it is not current, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a dtype pair, a form or a shape it does not
// take).

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

constexpr int kWarp = 32;
constexpr int kRows = 8;  // output rows a wide pass holds in registers
constexpr int kMaxK = 8;  // columns of x a pass holds in registers

// the kernel forms (ops/bsr_grouped.py _FORMS)
enum Form : int { kNarrowUnaligned = 0, kNarrow = 1, kWide = 2 };

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

// 32-bit word i of a 16-byte piece (i a constant after unrolling)
__device__ __forceinline__ unsigned word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// Value e of a piece of 16 / sizeof(T) values of T held as raw words,
// widened to A (a bf16 is the high half of an f32).
template <typename A, typename T>
__device__ __forceinline__ A piece_value(const uint4& w, int e) {
  if constexpr (sizeof(T) == 8) {
    return static_cast<A>(__hiloint2double(static_cast<int>(word(w, 2 * e + 1)),
                                           static_cast<int>(word(w, 2 * e))));
  } else if constexpr (sizeof(T) == 4) {
    return static_cast<A>(__uint_as_float(word(w, e)));
  } else {
    const unsigned u = word(w, e / 2);
    return static_cast<A>(__uint_as_float(e % 2 ? u & 0xffff0000u : u << 16));
  }
}

// N consecutive values of T at p, cast to A: in 16- or 8-byte words where
// N values fill them (p then aligned to the word), else one at a time.
template <typename A, typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, A (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4* q = reinterpret_cast<const uint4*>(p) + w;
      const uint4 u = __ldg(q);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[w * kPer + e] = piece_value<A, T>(u, e);
    }
  } else if constexpr (kBytes == 8) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 h = __ldg(q);
    const uint4 u = make_uint4(h.x, h.y, 0u, 0u);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = piece_value<A, T>(u, e);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_x<A>(__ldg(p + e));
  }
}

// The bytes a run of N values of T is loaded in by load_run (1: one value
// at a time).
template <typename T, int N>
__host__ __device__ constexpr int run_align() {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  return kBytes % 16 == 0 ? 16 : kBytes == 8 ? 8 : 1;
}

// Columns k0 .. k0 + kn of one x row (p points at column k0), cast to A
// and zero past kn; in words when `vec` says every such run is aligned.
template <typename A, typename X, int KT>
__device__ __forceinline__ void load_x(const X* __restrict__ p, A (&out)[KT], int kn,
                                       bool vec) {
  if constexpr (run_align<X, KT>() > 1) {
    if (vec && kn == KT) {
      load_run(p, out);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < KT; ++q) out[q] = q < kn ? to_x<A>(__ldg(p + q)) : A(0);
}

// Accumulator columns a lane of the wide form holds: kRows x kLaneCols
// sums are 32 registers (8 x 4 f32 or 8 x 2 f64), so that two blocks an SM
// fit without spilling.
template <typename A>
constexpr int kLaneCols = sizeof(A) == 8 ? 2 : 4;

// Wide form: one warp per block row (see the file's text).  A pass of KT
// columns splits the warp into S = KT / KL groups of L lanes; group s sums
// columns s*KL .. s*KL + KL of the pass over the whole group row, its lane
// l taking the pieces at columns P*l + L*P*t (the S lanes that share a
// piece read it in one transaction).  `xvec`: the x loads may use words
// (runs aligned, see launch_kt).
template <typename V, typename X, int KT>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_wide_kernel(const V* __restrict__ gdata, const int32_t* __restrict__ gcols,
                    const int64_t* __restrict__ gptr, const X* __restrict__ x,
                    X* __restrict__ y, int64_t nb_rows, int bh, int bw, int B, int64_t k,
                    bool xvec) {
  using A = typename Acc<X>::type;
  constexpr int P = 16 / sizeof(V);
  constexpr int KL = KT < kLaneCols<A> ? KT : kLaneCols<A>;
  constexpr int L = kWarp / (KT / KL);
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (r >= nb_rows) return;  // the whole warp: it owns one block row
  const int lane = threadIdx.x % kWarp;
  const int l = lane % L;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * KT + lane / L * KL;
  const int kn = k - k0 >= KL ? KL : k > k0 ? static_cast<int>(k - k0) : 0;
  const int W = B * bw;
  const int64_t g0 = gptr[r], g1 = gptr[r + 1];
  for (int h0 = 0; h0 < bh; h0 += kRows) {
    const int rows = bh - h0 < kRows ? bh - h0 : kRows;
    A acc[kRows][KL];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int q = 0; q < KL; ++q) acc[h][q] = A(0);
    for (int64_t g = g0; g < g1; ++g) {
      const V* vals = gdata + (g * bh + h0) * W;
      const int32_t* cols = gcols + g * B;
#pragma unroll 1
      for (int c = l * P; c < W; c += L * P) {
        const int j = c / bw;
        const X* xr = x + (static_cast<int64_t>(__ldg(cols + j)) * bw + (c - j * bw)) * k + k0;
        uint4 w[kRows];  // the rows' pieces, raw: 4 registers a row whatever V is
#pragma unroll
        for (int h = 0; h < kRows; ++h)
          if (h < rows)
            w[h] = __ldcs(reinterpret_cast<const uint4*>(vals + static_cast<int64_t>(h) * W + c));
        if constexpr (KT == 1) {  // k == 1: the piece's P x values are contiguous
          A xs[P];
          if (xvec) {
            load_run(xr, xs);
          } else {
#pragma unroll
            for (int e = 0; e < P; ++e) xs[e] = to_x<A>(__ldg(xr + e));
          }
#pragma unroll
          for (int e = 0; e < P; ++e)
#pragma unroll
            for (int h = 0; h < kRows; ++h)
              if (h < rows) acc[h][0] += piece_value<A, V>(w[h], e) * xs[e];
        } else {
#pragma unroll
          for (int e = 0; e < P; ++e) {
            A xe[KL];
            load_x<A, X, KL>(xr + e * k, xe, kn, xvec);
#pragma unroll
            for (int h = 0; h < kRows; ++h) {
              if (h < rows) {
                const A v = piece_value<A, V>(w[h], e);
#pragma unroll
                for (int q = 0; q < KL; ++q) acc[h][q] += v * xe[q];
              }
            }
          }
        }
      }
    }
    // fold each group's L lanes (xor offsets below L stay in the group)
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int q = 0; q < KL; ++q)
#pragma unroll
        for (int s = L / 2; s > 0; s >>= 1)
          acc[h][q] += __shfl_xor_sync(0xffffffffu, acc[h][q], s);
    // every lane of a group holds its sums; lane (h * KL + q) % L stores (h, q)
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int q = 0; q < KL; ++q)
        if (h < rows && q < kn && l == (h * KL + q) % L)
          y[(r * bh + h0 + h) * k + k0 + q] = from_acc<X, A>(acc[h][q]);
  }
}

// Narrow form: one thread per output row, its group rows read P values a
// load (P = 1: one value at a time), x gathered value by value.
template <typename V, typename X, int KT, int P>
__global__ void __launch_bounds__(kThreads, 1)
    bsr_narrow_kernel(const V* __restrict__ gdata, const int32_t* __restrict__ gcols,
                      const int64_t* __restrict__ gptr, const X* __restrict__ x,
                      X* __restrict__ y, int64_t n_rows, int bh, int bw, int B, int64_t k,
                      bool xvec) {
  using A = typename Acc<X>::type;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t r = row / bh;
  const int h = static_cast<int>(row - r * bh);
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * KT;
  const int kn = k - k0 < KT ? static_cast<int>(k - k0) : KT;
  const int W = B * bw;
  A acc[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) acc[q] = A(0);
  const int64_t g1 = gptr[r + 1];
  for (int64_t g = gptr[r]; g < g1; ++g) {
    const V* vals = gdata + (g * bh + h) * W;
    const int32_t* cols = gcols + g * B;
    int j = 0, cc = 0;  // block and column within it of the next value
#pragma unroll 1
    for (int c = 0; c < W; c += P) {
      A v[P];
      load_run(vals + c, v);
#pragma unroll
      for (int e = 0; e < P; ++e) {
        A xe[KT];
        load_x<A, X, KT>(x + (static_cast<int64_t>(__ldg(cols + j)) * bw + cc) * k + k0, xe,
                         kn, xvec);
#pragma unroll
        for (int q = 0; q < KT; ++q) acc[q] += v[e] * xe[q];
        if (++cc == bw) {
          cc = 0;
          ++j;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KT; ++q)
    if (q < kn) y[row * k + k0 + q] = from_acc<X, A>(acc[q]);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename V, typename X, int KT>
cudaError_t launch_kt(const void* gdata, const void* gcols, const void* gptr, const void* x,
                      void* y, int64_t nb_rows, int bh, int bw, int B, int64_t k, int form,
                      cudaStream_t stream) {
  const auto* gd = static_cast<const V*>(gdata);
  const auto* gc = static_cast<const int32_t*>(gcols);
  const auto* gp = static_cast<const int64_t*>(gptr);
  const auto* xp = static_cast<const X*>(x);
  auto* yp = static_cast<X*>(y);
  const unsigned passes = static_cast<unsigned>((k + KT - 1) / KT);
  // every run of KT x values (at a multiple of k plus a multiple of KT)
  // starts on a word boundary when x does and k values fill words
  constexpr int kRun = run_align<X, KT>();
  const bool runs = aligned(x, kRun) && (k * static_cast<int64_t>(sizeof(X))) % kRun == 0;
  if (form == kWide) {
    constexpr int P = 16 / sizeof(V);
    constexpr int kCols = kLaneCols<typename Acc<X>::type>;
    constexpr int KL = KT < kCols ? KT : kCols;
    constexpr int kLaneRun = run_align<X, KL>();
    // k == 1: a piece's P x values start at a multiple of P; else each lane
    // loads runs of KL values
    const bool xvec = KT == 1 ? aligned(x, run_align<X, P>())
                              : aligned(x, kLaneRun) &&
                                    (k * static_cast<int64_t>(sizeof(X))) % kLaneRun == 0;
    const dim3 grid(blocks_for(nb_rows * kWarp), passes);
    bsr_wide_kernel<V, X, KT><<<grid, kThreads, 0, stream>>>(gd, gc, gp, xp, yp, nb_rows, bh, bw,
                                                             B, k, xvec);
  } else {
    const dim3 grid(blocks_for(nb_rows * bh), passes);
    if (form == kNarrow)
      bsr_narrow_kernel<V, X, KT, 16 / sizeof(V)><<<grid, kThreads, 0, stream>>>(
          gd, gc, gp, xp, yp, nb_rows * bh, bh, bw, B, k, runs);
    else
      bsr_narrow_kernel<V, X, KT, 1><<<grid, kThreads, 0, stream>>>(
          gd, gc, gp, xp, yp, nb_rows * bh, bh, bw, B, k, runs);
  }
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch(const void* gdata, const void* gcols, const void* gptr, const void* x,
                   void* y, int64_t nb_rows, int bh, int bw, int B, int64_t k, int form,
                   cudaStream_t s) {
  constexpr int P = 16 / sizeof(V);
  const int64_t row_bytes = static_cast<int64_t>(B) * bw * sizeof(V);
  if (form != kNarrowUnaligned && (!aligned(gdata, 16) || row_bytes % 16 != 0))
    return cudaErrorInvalidValue;
  if (form == kWide && bw % P != 0) return cudaErrorInvalidValue;
  const int kt = k == 1 ? 1 : k == 2 ? 2 : k <= 4 ? 4 : kMaxK;
  if (kt == 1) return launch_kt<V, X, 1>(gdata, gcols, gptr, x, y, nb_rows, bh, bw, B, k, form, s);
  if (kt == 2) return launch_kt<V, X, 2>(gdata, gcols, gptr, x, y, nb_rows, bh, bw, B, k, form, s);
  if (kt == 4) return launch_kt<V, X, 4>(gdata, gcols, gptr, x, y, nb_rows, bh, bw, B, k, form, s);
  return launch_kt<V, X, kMaxK>(gdata, gcols, gptr, x, y, nb_rows, bh, bw, B, k, form, s);
}

}  // namespace

// (device, value type, vector type, gdata (G, bh, B*bw), gcols (G, B) int32,
//  gptr (nb_rows + 1) int64, x (nb_cols*bw, k), y (nb_rows*bh, k),
//  nb_rows, bh, bw, B, k, form, stream)
extern "C" int sigma_bsr_grouped_spmv(int device, int vtype, int xtype, const void* gdata,
                                      const void* gcols, const void* gptr, const void* x,
                                      void* y, int64_t nb_rows, int64_t bh, int64_t bw,
                                      int64_t B, int64_t k, int64_t form, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form < kNarrowUnaligned || form > kWide) return cudaErrorInvalidValue;
  if (nb_rows < 1 || bh < 1 || bw < 1 || B < 1 || k < 1 || bh > INT32_MAX ||
      B * bw > INT32_MAX)
    return cudaErrorInvalidValue;
  const int ibh = static_cast<int>(bh), ibw = static_cast<int>(bw), iB = static_cast<int>(B);
  const int f = static_cast<int>(form);
#define SIGMA_BSR_CASE(VC, XC, V, X)                                               \
  if (vtype == VC && xtype == XC)                                                  \
    return launch<V, X>(gdata, gcols, gptr, x, y, nb_rows, ibh, ibw, iB, k, f, s);
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
