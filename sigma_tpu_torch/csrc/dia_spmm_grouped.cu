// DIA sparse matrix times k dense panels for any k, each stored value read
// from device memory once for all k, for Hopper (sm_90a).
//
//   dia_spmm_grouped  replaces sigma_tpu/ops/spmv_pallas.py dia_spmm_grouped
//                     and dia_spmm_grouped_chunked: Y = A X from
//                     full-storage DIA, rectangular n x m, for k > 16
//                     right-hand sides on wide bands (DIAMatrix.matmat's
//                     grouped route; LOBPCG's [X, W, P] basis is k = 3m).
//
// What bounds it.  On a wide band the values dominate (245 diagonals of an
// RCM-ordered mesh against 2k panel values per row).  The byte floor is the
// values once plus k x-panels read and k y-panels written: 9.89 + 1.29 +
// 1.29 GB for the 10.1M-row band at k = 32 in f32, 4.2 ms at the copy
// rate.  The arithmetic is k FMAs per stored value (2.7 ms of f32 FMA for
// that product), and every FMA needs its x operand from on-chip memory, so
// a kernel has to feed the FMAs from registers and shared memory at no more
// than one byte of shared-memory read per FMA while the value stream runs
// underneath.  The TPU kernel got the single value stream by revisiting
// each data tile across an outer grid axis over groups of panels, and read
// x from VMEM windows.
//
// Design.  A block owns 256 consecutive rows and 32 columns (16 for f64
// vectors); 256 threads, each a register tile of R = 4 consecutive rows x C
// = 8 columns (4 for f64).
//
// 1. The x window, staged once per block.  Before it walks the diagonals
//    the block stages rows [i0 + min offset, i0 + 255 + max offset] of its
//    columns into shared memory (500 rows, 72 KB for the 10.1M-row band):
//    16-byte cp.async pieces from (m, k) column panels, whose window row is
//    contiguous; 4- or 8-byte pieces from RHS-major panels, where the copy
//    transposes.  Zeros outside [0, m) and past k.  The window's row stride
//    is its width plus 16 bytes, so the compute's 16-byte reads are free of
//    bank conflicts.  Offsets whose joint span does not fit the window
//    space fall into runs of consecutive diagonals that do (a stencil's
//    offsets +-n^2 apart, a band too wide), one window staged per run.
// 2. Values through a ring.  Stages of 8 KB (8 diagonals x 256 rows in
//    f32, 16 in bf16, 4 in f64) and their offsets come in by cp.async, four
//    buffers, three stages in flight while the block computes on the
//    fourth (cp.async.wait_group 2).  Each value is read from device
//    memory once per column group.
// 3. The register tile, with x carried along the band.  At consecutive
//    offsets o, o + 1, rows i .. i + 3 need x[i + o .. i + o + 3] and then
//    x[i + o + 1 .. i + o + 4]: a shift register of 4 window rows x C
//    columns takes one new window row per diagonal, C / 4 16-byte reads for
//    4 C FMAs (one byte per FMA in f32 and f64).  The diagonal loop is
//    unrolled by the stage (by 4 with f64 vectors, where the 128 registers
//    allow no more), so the shift is register renaming.  A gap in the
//    offsets reloads the four rows.  A run of consecutive offsets (a band)
//    in a block inside [0, m) takes a loop that reads no offsets and tests
//    nothing: diagonal t of the run reads window row t + 3.  The thread's
//    4 values of one diagonal are one 16-byte read (8 bytes in bf16); its
//    results are stored in 16-byte pieces where y's layout allows.
//
// Shared memory: 110 KB a block, two blocks an SM (the register tile's 32
// accumulators and 32 x values fit the 128 registers that allows; f64
// values with f64 vectors take one block an SM, as ptxas spills their
// loads in flight under 128): the ring (32 KB), its offsets, and the
// window (up to 552 rows, a band of reach 148).
//
// More than 32 columns (16 in f64): the grid holds one block per 256 rows
// and column group, the groups of one row block next to each other, so
// they run side by side and the second group's value reads come from L2.
// No partial sums go through y.
//
// Order of each row's sum: ascending diagonal, one fused multiply-add per
// term in the vector type, as the plain version.  Out-of-range terms are
// selected away (the value becomes 0 and the window holds 0; blocks whose
// window lies inside [0, m) run a loop with no masks).  64-bit row and
// slot indices; D = 0 writes zeros.  Panels: the Panels block-length
// addressing of dia_spmm.cu, B = m (or n) for RHS-major (k, m) panels and
// B = 1 for (m, k) columns; the five (value, vector) dtype pairs.
//
// Interface.  One plain C entry point bound with ctypes; it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k or a
// panel-block length it does not take.  sigma_dia_spmm_grouped_config
// reports an instantiation's shared memory and window rows.

#include <climits>

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

constexpr int kRows = 256;              // rows a block
constexpr int kR = 4;                   // rows a thread
constexpr int kColGroups = 4;           // threads on one row group
constexpr int kBlock = kRows / kR * kColGroups;  // 256 threads
constexpr int kStages = 4;              // ring buffers (kStages - 1 in flight)
constexpr int kStageBytes = 8 * 1024;   // values a stage
constexpr int kSmemBytes = 110 * 1024;  // dynamic shared memory a block (2 an SM)

template <typename V, typename X>
struct Cfg {
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(X));  // x values a 16-byte piece
  static constexpr int kC = sizeof(X) == 8 ? 4 : 8;                // columns a thread
  static constexpr int kPieces = kC / kPiece;                      // pieces a thread a window row
  static constexpr int kCols = kColGroups * kC;                    // columns a block
  static constexpr int kRowStride = kCols * static_cast<int>(sizeof(X)) + 16;  // window bytes
  static constexpr int kDiags = kStageBytes / (kRows * static_cast<int>(sizeof(V)));
  static constexpr int kOffsetBytes = kStages * kDiags * 8;
  static constexpr int kWindowOffset = kStages * kStageBytes + kOffsetBytes;
  static constexpr int kWindowRows = (kSmemBytes - kWindowOffset) / kRowStride;
  // blocks an SM the registers must allow: two (128 registers a thread),
  // but one for f64 values with f64 vectors, whose loads in flight ptxas
  // would spill under 128
  static constexpr int kMinBlocks = sizeof(V) == 8 && sizeof(X) == 8 ? 1 : 2;
  static_assert(kDiags % kR == 0, "a stage holds whole register-tile phases");
  static_assert(kWindowRows > kRows, "the window holds at least one block's rows");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of N bytes (4, 8 or 16) from global to shared memory;
// zeros instead when !valid (src is then not read).
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  const int bytes = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(N), "r"(bytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fma_x(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_x(double a, double b, double c) { return fma(a, b, c); }

// A thread's 4 values of one diagonal (4 consecutive rows), widened to X.
template <typename X>
__device__ __forceinline__ void load_values(const float* p, X (&v)[kR]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
template <typename X>
__device__ __forceinline__ void load_values(const double* p, X (&v)[kR]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = static_cast<X>(a.x), v[1] = static_cast<X>(a.y);
  v[2] = static_cast<X>(b.x), v[3] = static_cast<X>(b.y);
}
template <typename X>
__device__ __forceinline__ void load_values(const __nv_bfloat16* p, X (&v)[kR]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = to_x<X>(lo.x), v[1] = to_x<X>(lo.y), v[2] = to_x<X>(hi.x), v[3] = to_x<X>(hi.y);
}

// One 16-byte piece of a window row into registers.
__device__ __forceinline__ void load_piece(const float* p, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
}
__device__ __forceinline__ void load_piece(const double* p, double* r) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  r[0] = a.x, r[1] = a.y;
}

template <typename V, typename X>
struct Tile {
  using C = Cfg<V, X>;
  // groups of kR diagonals unrolled together: the whole stage with f32
  // vectors; one group at a time with f64 (the register cap allows no more
  // loads in flight without spilling)
  static constexpr int kOuterUnroll = sizeof(X) == 8 ? 1 : C::kDiags / kR;
  X acc[kR][C::kC];  // row q, column c
  X xr[kR][C::kC];   // the shift register: window row (phase + q) % kR for row q

  // window row ``row`` of this thread's columns into slot s
  __device__ __forceinline__ void load_row(int s, const unsigned char* xw, int row) {
    const X* p = reinterpret_cast<const X*>(xw + row * C::kRowStride);
#pragma unroll
    for (int h = 0; h < C::kPieces; ++h)
      load_piece(p + h * kColGroups * C::kPiece, &xr[s][h * C::kPiece]);
  }

  // The first ``count`` diagonals of one ring stage: values sv (this
  // thread's rows), offsets so.  Offsets are taken relative to the run's
  // lowest, lo: diagonal o reads window rows o - lo + q, and row q's term is
  // in range when cmin <= o - lo + q < cmax (all rows are unless kEdge);
  // prev: the relative offset of the diagonal before.
  template <bool kEdge>
  __device__ __forceinline__ void stage(const V* sv, const int64_t* so, int count,
                                        const unsigned char* xw, int64_t lo, int& prev,
                                        int cmin, int cmax) {
#pragma unroll (kOuterUnroll)
    for (int t0 = 0; t0 < C::kDiags; t0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {  // u: the shift register's phase
        const int t = t0 + u;
        if (t >= count) return;
        const int rel = static_cast<int>(so[t] - lo);
        X v[kR];
        load_values<X>(sv + t * kRows, v);
        if (rel == prev + 1) {
          // rows 0 .. 2 take rows 1 .. 3's x of the diagonal before
          load_row((u + kR - 1) % kR, xw, rel + kR - 1);
        } else {
#pragma unroll
          for (int q = 0; q < kR; ++q) load_row((u + q) % kR, xw, rel + q);
        }
        prev = rel;
        if (kEdge) {
#pragma unroll
          for (int q = 0; q < kR; ++q)
            if (rel + q < cmin || rel + q >= cmax) v[q] = X(0);
        }
        fma_tile(u, v);
      }
    }
  }

  // row q += v[q] * x of row q, for the phase u's slots
  __device__ __forceinline__ void fma_tile(int u, const X (&v)[kR]) {
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int c = 0; c < C::kC; ++c)
        acc[q][c] = fma_x(v[q], xr[(u + q) % kR][c], acc[q][c]);
  }

  // A whole stage of a band's consecutive offsets inside [0, m): diagonal t
  // reads window row t + 3 from xw (this thread's window row of the
  // stage's first diagonal), no offsets and no masks; ``first``: the run
  // starts here, so rows 0 .. 2 are loaded too.
  __device__ __forceinline__ void band_stage(const V* sv, const unsigned char* xw, bool first) {
    if (first) {
#pragma unroll
      for (int q = 0; q < kR - 1; ++q) load_row(q, xw, q);
    }
#pragma unroll (kOuterUnroll)
    for (int t0 = 0; t0 < C::kDiags; t0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const int t = t0 + u;
        X v[kR];
        load_values<X>(sv + t * kRows, v);
        load_row((u + kR - 1) % kR, xw, t + kR - 1);
        fma_tile(u, v);
      }
    }
  }
};

__device__ __forceinline__ void store_piece(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store_piece(double* p, const double* r) {
  *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

template <typename V, typename X>
__global__ void __launch_bounds__(kBlock, (Cfg<V, X>::kMinBlocks))
    dia_spmm_grouped_kernel(const V* __restrict__ data, const X* __restrict__ x,
                            const int64_t* __restrict__ offsets, X* __restrict__ y,
                            int64_t D, int64_t stride, int64_t n, int64_t m, int k,
                            Panels px, Panels py, int groups, bool x_pieces) {
  using C = Cfg<V, X>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* s_val = reinterpret_cast<V*>(smem);
  int64_t* s_off = reinterpret_cast<int64_t*>(smem + kStages * kStageBytes);
  unsigned char* s_win = smem + C::kWindowOffset;
  __shared__ long long s_lo, s_hi;  // offset range of the band, then of a run
  __shared__ long long s_end;       // a run's end
  __shared__ int s_band;            // the run's offsets are consecutive
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups, rg = tid / kColGroups;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x / groups) * kRows;
  const int j0 = static_cast<int>(blockIdx.x % groups) * C::kCols;
  const int64_t i = i0 + kR * rg;  // this thread's rows: i .. i + 3
  // this thread's first window row and first column (its h-th piece is
  // kColGroups pieces further on)
  const unsigned char* xw =
      s_win + (kR * rg) * C::kRowStride + cg * C::kPiece * static_cast<int>(sizeof(X));

  Tile<V, X> tile;
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int c = 0; c < C::kC; ++c) tile.acc[q][c] = X(0);

  // the band's offset range; one run when its window fits
  if (tid == 0) s_lo = LLONG_MAX, s_hi = LLONG_MIN;
  __syncthreads();
  {
    long long lo = LLONG_MAX, hi = LLONG_MIN;
    for (int64_t d = tid; d < D; d += kBlock) {
      const long long o = offsets[d];
      lo = o < lo ? o : lo;
      hi = o > hi ? o : hi;
    }
    if (lo <= hi) atomicMin(&s_lo, lo), atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const bool one_run = D > 0 && s_hi - s_lo + kRows <= C::kWindowRows;
  int64_t lo = s_lo, hi = s_hi;
  bool band = false;  // offsets[d] == offsets[d0] + d - d0 over the run
  if (one_run) {
    bool ok = true;
    for (int64_t d = tid; d < D; d += kBlock) ok &= offsets[d] == lo + d;
    band = __syncthreads_and(ok);
  }

  for (int64_t d0 = 0; d0 < D;) {
    int64_t d_end = D;
    if (!one_run) {
      __syncthreads();  // the previous run's scalars are read
      if (tid == 0) {
        // the longest run of diagonals from d0 whose joint window fits
        long long rlo = offsets[d0], rhi = rlo;
        int consecutive = 1;
        int64_t e = d0 + 1;
        for (; e < D; ++e) {
          const long long o = offsets[e];
          const long long nlo = o < rlo ? o : rlo, nhi = o > rhi ? o : rhi;
          if (nhi - nlo + kRows > C::kWindowRows) break;
          consecutive &= o == offsets[e - 1] + 1;
          rlo = nlo, rhi = nhi;
        }
        s_lo = rlo, s_hi = rhi, s_end = e, s_band = consecutive;
      }
      __syncthreads();
      lo = s_lo, hi = s_hi, d_end = s_end, band = s_band;
    }
    const int64_t w0 = i0 + lo;
    const int span = static_cast<int>(hi - lo) + kRows;  // window rows

    // the window: rows w0 .. w0 + span - 1, columns j0 .. j0 + kCols - 1
    if (x_pieces) {
      // (m, k) columns, k a whole number of pieces: 16-byte pieces
      constexpr int kRowPieces = C::kCols / C::kPiece;
      for (int e = tid; e < span * kRowPieces; e += kBlock) {
        const int r = e / kRowPieces, u = e % kRowPieces;
        const int64_t c = w0 + r;
        const int j = j0 + u * C::kPiece;
        const bool valid = c >= 0 && c < m && j < k;
        copy_async<16>(s_win + r * C::kRowStride + u * 16, valid ? x + c * k + j : x, valid);
      }
    } else if (px.B == 1) {
      for (int e = tid; e < span * C::kCols; e += kBlock) {
        const int r = e / C::kCols, jj = e % C::kCols;
        const int64_t c = w0 + r;
        const bool valid = c >= 0 && c < m && j0 + jj < k;
        copy_async<static_cast<int>(sizeof(X))>(
            s_win + r * C::kRowStride + jj * static_cast<int>(sizeof(X)),
            valid ? x + c * k + j0 + jj : x, valid);
      }
    } else {
      // RHS-major panels: consecutive threads take a column's consecutive rows
      for (int jj = 0; jj < C::kCols; ++jj) {
        const bool col = j0 + jj < k;
        const X* xj = x + static_cast<int64_t>(j0 + jj) * px.B;
        for (int r = tid; r < span; r += kBlock) {
          const int64_t c = w0 + r;
          const bool valid = col && c >= 0 && c < m;
          copy_async<static_cast<int>(sizeof(X))>(
              s_win + r * C::kRowStride + jj * static_cast<int>(sizeof(X)),
              valid ? xj + px.at(c) : x, valid);
        }
      }
    }

    // the ring: stage s holds diagonals d0 + s kDiags .. of this block's rows
    const int n_stages = static_cast<int>((d_end - d0 + C::kDiags - 1) / C::kDiags);
    auto load_stage = [&](int s) {
      const int buf = s % kStages;
      const int64_t ds = d0 + static_cast<int64_t>(s) * C::kDiags;
      constexpr int kPer = 16 / static_cast<int>(sizeof(V));  // values a copy
      constexpr int kChunks = kRows / kPer;                   // copies a diagonal
      V* sv = s_val + buf * (kStageBytes / static_cast<int>(sizeof(V)));
      for (int e = tid; e < C::kDiags * kChunks; e += kBlock) {
        const int t = e / kChunks, q = e % kChunks;
        if (ds + t >= d_end) break;
        const int64_t row = i0 + static_cast<int64_t>(q) * kPer;
        const bool valid = row < stride;  // rows past the stored stride read as zero
        copy_async<16>(sv + t * kRows + q * kPer, valid ? data + (ds + t) * stride + row : data,
                       valid);
      }
      if (tid < C::kDiags && ds + tid < d_end)
        copy_async<8>(s_off + buf * C::kDiags + tid, offsets + ds + tid, true);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {  // the window joins stage 0's group
      if (s < n_stages) load_stage(s);
      copy_commit();
    }
    const bool edge = w0 < 0 || i0 + kRows - 1 + hi >= m;
    // row i + q's column at relative offset r is i + lo + r + q: in [0, m)
    // for cmin <= r + q < cmax (clamped: r + q lies in [0, span + 3])
    auto clamp_rel = [&](int64_t v) {
      return static_cast<int>(v < -1 ? -1 : v > span + kR ? span + kR : v);
    };
    const int cmin = clamp_rel(-(i + lo)), cmax = clamp_rel(m - (i + lo));
    int prev = -2;  // no diagonal before the run's first
    for (int s = 0; s < n_stages; ++s) {
      copy_wait<kStages - 2>();
      __syncthreads();  // stage s has landed; stage s - 1's buffer is free
      if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1);
      copy_commit();
      const int buf = s % kStages;
      const V* sv = s_val + buf * (kStageBytes / static_cast<int>(sizeof(V))) + kR * rg;
      const int64_t* so = s_off + buf * C::kDiags;
      const int64_t ds = d0 + static_cast<int64_t>(s) * C::kDiags;
      const int count = static_cast<int>(d_end - ds < C::kDiags ? d_end - ds : C::kDiags);
      if (band && !edge && count == C::kDiags) {
        // a band's offsets are lo + (d - d0): window row d - d0 + q for row q
        tile.band_stage(sv, xw + static_cast<int>(ds - d0) * C::kRowStride, s == 0);
        prev = static_cast<int>(ds - d0) + C::kDiags - 1;
      } else if (edge) {
        tile.template stage<true>(sv, so, count, xw, lo, prev, cmin, cmax);
      } else {
        tile.template stage<false>(sv, so, count, xw, lo, prev, cmin, cmax);
      }
    }
    copy_wait<0>();
    __syncthreads();  // the window and the ring are consumed
    d0 = d_end;
  }

  // y: this thread's rows and columns, in 16-byte pieces where aligned
  if (i >= n) return;
  const bool y_aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (py.B == 1 && k % C::kPiece == 0 && y_aligned) {
    // (n, k) columns: a piece is kPiece consecutive columns of one row
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (i + q >= n) break;
#pragma unroll
      for (int h = 0; h < C::kPieces; ++h) {
        const int j = j0 + (h * kColGroups + cg) * C::kPiece;
        if (j < k) store_piece(y + (i + q) * k + j, &tile.acc[q][h * C::kPiece]);
      }
    }
  } else if (py.B >= n && py.B % C::kPiece == 0 && y_aligned && i + kR <= n) {
    // RHS-major panels: a piece is kPiece consecutive rows of one column
#pragma unroll
    for (int c = 0; c < C::kC; ++c) {
      const int j = j0 + (c / C::kPiece * kColGroups + cg) * C::kPiece + c % C::kPiece;
      if (j >= k) continue;
#pragma unroll
      for (int q = 0; q < kR; q += C::kPiece) {
        X piece[C::kPiece];
#pragma unroll
        for (int e = 0; e < C::kPiece; ++e) piece[e] = tile.acc[q + e][c];
        store_piece(y + static_cast<int64_t>(j) * py.B + i + q, piece);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int64_t r = i + q;
      if (r >= n) break;
#pragma unroll
      for (int c = 0; c < C::kC; ++c) {
        const int j = j0 + (c / C::kPiece * kColGroups + cg) * C::kPiece + c % C::kPiece;
        if (j < k) y[py.at(r) + static_cast<int64_t>(j) * py.B] = tile.acc[q][c];
      }
    }
  }
}

template <typename V, typename X>
cudaError_t launch(const void* data, const void* x, const void* offsets, void* y,
                   int64_t D, int64_t stride, int64_t n, int64_t m, int k, Panels px,
                   Panels py, cudaStream_t stream) {
  using C = Cfg<V, X>;
  // 16-byte value copies: aligned rows, whole copies within a row
  if (reinterpret_cast<uintptr_t>(data) % 16 || stride % (16 / sizeof(V)))
    return cudaErrorInvalidValue;
  const int groups = (k + C::kCols - 1) / C::kCols;
  const int64_t blocks = (n + kRows - 1) / kRows * groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = dia_spmm_grouped_kernel<V, X>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // (m, k) columns in 16-byte pieces: k a whole number of pieces, x aligned
  const bool x_pieces = px.B == 1 && k % C::kPiece == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kBlock, kSmemBytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m, k, px, py,
      groups, x_pieces);
  return cudaGetLastError();
}

template <typename V, typename X>
void config(int64_t* out) {
  using C = Cfg<V, X>;
  out[0] = kSmemBytes;
  out[1] = C::kWindowRows;
  out[2] = C::kDiags;
  out[3] = kStages;
  out[4] = C::kCols;
  out[5] = C::kMinBlocks;
}

}  // namespace

extern "C" int sigma_dia_spmm_grouped(int device, int vtype, int xtype, const void* data,
                                      const void* x, const void* offsets, void* y,
                                      int64_t D, int64_t stride, int64_t n, int64_t m,
                                      int64_t k, int64_t bx, int64_t by, void* stream) {
  Panels px, py;
  if (k < 1 || k > (int64_t(1) << 30) || !make_panels(bx, k, m, &px) ||
      !make_panels(by, k, n, &py))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (xtype == kF32) {
    if (vtype == kF32) return launch<float, float>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kBF16) return launch<__nv_bfloat16, float>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
  } else if (xtype == kF64) {
    if (vtype == kF64) return launch<double, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kF32) return launch<float, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
    if (vtype == kBF16) return launch<__nv_bfloat16, double>(data, x, offsets, y, D, stride, n, m, kk, px, py, s);
  }
  return cudaErrorInvalidValue;
}

// An instantiation's launch shape: out[0..5] = dynamic shared memory bytes
// a block, window rows, diagonals a ring stage, ring stages, columns a
// block, and the blocks an SM its register bound allows.  Returns cudaErrorInvalidValue for a dtype pair it does not take.
extern "C" int sigma_dia_spmm_grouped_config(int vtype, int xtype, int64_t* out) {
  if (xtype == kF32 && vtype == kF32) return config<float, float>(out), 0;
  if (xtype == kF32 && vtype == kBF16) return config<__nv_bfloat16, float>(out), 0;
  if (xtype == kF64 && vtype == kF64) return config<double, double>(out), 0;
  if (xtype == kF64 && vtype == kF32) return config<float, double>(out), 0;
  if (xtype == kF64 && vtype == kBF16) return config<__nv_bfloat16, double>(out), 0;
  return cudaErrorInvalidValue;
}
