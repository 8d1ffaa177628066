// The staged-window machinery of the full-storage DIA SpMM kernels for
// Hopper (sm_90a), shared by dia_spmm.cu (1 <= k <= 16 panels in three
// layouts) and dia_spmm_grouped.cu (any k): Y = A X with each stored value
// read from device memory once for all of a block's columns.
//
// Block shape.  256 threads, each a register tile of R = 4 consecutive rows
// x C columns (C = 8 with f32 vectors, 4 with f64: 32 bytes a tile row).
// G threads side by side share one group of 4 rows (G column groups), so a
// block owns kRows = 1024 / G rows and kCols = G C columns.  A kernel picks
// G: dia_spmm the smallest that covers k (no thread computes only zeros
// past k), dia_spmm_grouped G = 4 (256 rows, 32 or 16 columns a block).
//
// 1. The x window.  Before it walks a run of diagonals the block stages
//    rows [i0 + lo, i0 + kRows - 1 + hi] of its columns, zeros outside
//    [0, m) and past k, into shared memory: from (m, k) columns in 16-byte
//    cp.async pieces of a window row (k a whole number of pieces), else in
//    single values; from panels (RHS-major, interleaved) in 16-byte global
//    loads of 4 (f32) or 2 (f64) consecutive rows of one column, written
//    to their window rows (the panel length a whole number of pieces), else
//    in single values.  Layout: window rows of kCols columns, and after
//    every 4 rows 16 G bytes of padding, so the 8 threads of a quarter warp
//    reading 16-byte pieces of rows 4 t + c (t the thread's row group) hit
//    8 distinct bank quads for every c: conflict-free.  Offsets whose joint
//    span does not fit the window space fall into runs of consecutive
//    diagonals that do (a stencil's offsets +-nx^2 apart, a band too wide),
//    one window staged per run.
// 2. Values through a ring.  Stages of kDiags diagonals x kRows rows and
//    their offsets come in by cp.async (16-byte pieces where the value rows
//    are 16-byte aligned, else single values), kStages buffers, kStages - 1
//    in flight while the block computes on the oldest.
// 3. The register tile, with x carried along the band.  At consecutive
//    offsets o, o + 1 rows i .. i + 3 need x[i + o .. i + o + 3] and then
//    x[i + o + 1 .. i + o + 4]: a shift register of 4 window rows x C
//    columns takes one new window row per diagonal, two 16-byte reads for
//    4 C FMAs (one byte of shared memory per FMA).  The diagonal loop is
//    unrolled by whole register-tile phases, so the shift is register
//    renaming; a gap in the offsets reloads the four rows.  A run of
//    consecutive offsets in a block whose window lies inside [0, m) takes a
//    loop that reads no offsets and tests nothing.
// 4. Isolated diagonals (optional, panels only): a run of one diagonal can
//    skip the window and the ring, each thread loading its 4 values and its
//    4 rows of x straight into the register tile (16-byte pieces where
//    aligned).
//
// Order of each row's sum: ascending diagonal, one fused multiply-add per
// term in the vector type.  Out-of-range terms are selected away (the value
// becomes 0 and x holds 0).  64-bit row and slot indices; D = 0 writes
// zeros.  Rows n .. rows_out - 1 of y (the interleaved layout's padding)
// are written as zeros.

#pragma once

#include <climits>
#include <cstdint>

#include "dia_common.cuh"

namespace sigma_dia {

constexpr int kR = 4;                // rows a thread
constexpr int kBlockThreads = 256;  // threads a block

// How a block stages x (chosen by the launcher, the same for all blocks)
enum XRoute : int {
  kColPieces = 0,    // (m, k) columns, 16-byte pieces of a window row
  kColValues = 1,    // (m, k) columns, single values
  kPanelPieces = 2,  // panels, 16-byte pieces of consecutive rows of one column
  kPanelValues = 3,  // panels, single values
};

// A block's shape: value type V, vector type X, G column groups, ring
// stages of about StageBytes (at least one register-tile phase), Stages
// ring buffers, SmemBytes of dynamic shared memory.
template <typename V, typename X, int G, int StageBytes, int Stages, int SmemBytes, int Batch>
struct WindowShape {
  using Value = V;
  using Vec = X;
  static constexpr int kGroups = G;
  static constexpr int kRows = kR * kBlockThreads / G;            // rows a block
  static constexpr int kStages = Stages;
  static constexpr int kSmemBytes = SmemBytes;
  static constexpr int kBatch = Batch;  // 16-byte panel pieces in flight a thread
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(X));  // x values a 16-byte piece
  static constexpr int kC = sizeof(X) == 8 ? 4 : 8;                // columns a thread
  static constexpr int kPieces = kC / kPiece;                      // pieces a thread a window row
  static constexpr int kCols = G * kC;                             // columns a block
  static constexpr int kRowBytes = kCols * static_cast<int>(sizeof(X));
  static constexpr int kGroupBytes = kR * kRowBytes + 16 * G;      // 4 window rows + padding
  static constexpr int kFit = StageBytes / (kRows * static_cast<int>(sizeof(V)));
  static constexpr int kDiags = kFit < kR ? kR : kFit;             // diagonals a ring stage
  static constexpr int kStageValues = kDiags * kRows;
  static constexpr int kRingBytes = kStages * kStageValues * static_cast<int>(sizeof(V));
  static constexpr int kOffsetBytes = kStages * kDiags * 8;
  static constexpr int kWindowOffset = kRingBytes + kOffsetBytes;
  static constexpr int kWindowRows = (kSmemBytes - kWindowOffset) / kGroupBytes * kR;
  // blocks an SM the registers must allow: two (128 registers a thread),
  // but one for f64 values with f64 vectors, whose loads in flight ptxas
  // would spill under 128
  static constexpr int kMinBlocks = sizeof(V) == 8 && sizeof(X) == 8 ? 1 : 2;
  // register-tile phases unrolled together: the whole stage with f32
  // vectors; one at a time with f64 (the register cap allows no more loads
  // in flight without spilling)
  static constexpr int kOuterUnroll = sizeof(X) == 8 ? 1 : kDiags / kR;
  static_assert(kBlockThreads % G == 0, "whole row groups");
  static_assert(kDiags % kR == 0, "a stage holds whole register-tile phases");
  static_assert(kWindowOffset % 16 == 0, "the window is 16-byte aligned");
  static_assert(kWindowRows > kRows, "the window holds at least one block's rows");
};

// The staging route of x (host): 16-byte pieces where a (m, k) row or a
// panel block is a whole number of pieces and x is 16-byte aligned.
template <class S>
inline int pick_route(const void* x, int k, const Panels& px) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (px.B == 1) return k % S::kPiece == 0 && aligned ? kColPieces : kColValues;
  return px.B % S::kPiece == 0 && aligned ? kPanelPieces : kPanelValues;
}

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

// A thread's 4 values of one diagonal (4 consecutive rows), widened to X;
// p is 16-byte aligned (8-byte for bf16).
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

// One 16-byte piece into registers, and back.
__device__ __forceinline__ void load_piece(const float* p, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
}
__device__ __forceinline__ void load_piece(const double* p, double* r) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  r[0] = a.x, r[1] = a.y;
}
__device__ __forceinline__ void store_piece(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store_piece(double* p, const double* r) {
  *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

// Byte position of window row r (rows of kRowBytes, padding after every 4).
template <class S>
__device__ __forceinline__ int window_row(int r) {
  return (r >> 2) * S::kGroupBytes + (r & 3) * S::kRowBytes;
}

template <class S>
struct WindowTile {
  using V = typename S::Value;
  using X = typename S::Vec;
  X acc[kR][S::kC];  // row q, column c
  X xr[kR][S::kC];   // the shift register: window row (phase + q) % kR for row q

  // window row ``row`` (relative to the thread's first) of this thread's
  // columns into slot s; xw: the thread's first window row and first piece
  __device__ __forceinline__ void load_row(int s, const unsigned char* xw, int row) {
    const X* p = reinterpret_cast<const X*>(xw + window_row<S>(row));
#pragma unroll
    for (int h = 0; h < S::kPieces; ++h)
      load_piece(p + h * S::kGroups * S::kPiece, &xr[s][h * S::kPiece]);
  }

  // row q += v[q] * x of row q, for the phase u's slots
  __device__ __forceinline__ void fma_tile(int u, const X (&v)[kR]) {
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int c = 0; c < S::kC; ++c)
        acc[q][c] = fma_x(v[q], xr[(u + q) % kR][c], acc[q][c]);
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
#pragma unroll (S::kOuterUnroll)
    for (int t0 = 0; t0 < S::kDiags; t0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {  // u: the shift register's phase
        const int t = t0 + u;
        if (t >= count) return;
        const int rel = static_cast<int>(so[t] - lo);
        X v[kR];
        load_values<X>(sv + t * S::kRows, v);
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

  // A whole stage of a band's consecutive offsets inside [0, m): diagonal t
  // reads window row t + 3 from xw (this thread's window row of the
  // stage's first diagonal, a multiple of 4 rows on), no offsets and no
  // masks; ``first``: the run starts here, so rows 0 .. 2 are loaded too.
  __device__ __forceinline__ void band_stage(const V* sv, const unsigned char* xw, bool first) {
    if (first) {
#pragma unroll
      for (int q = 0; q < kR - 1; ++q) load_row(q, xw, q);
    }
#pragma unroll (S::kOuterUnroll)
    for (int t0 = 0; t0 < S::kDiags; t0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const int t = t0 + u;
        X v[kR];
        load_values<X>(sv + t * S::kRows, v);
        load_row((u + kR - 1) % kR, xw, t + kR - 1);
        fma_tile(u, v);
      }
    }
  }
};

// Column of slot c of thread cg's tile (its pieces are G pieces apart).
template <class S>
__device__ __forceinline__ int tile_column(int j0, int cg, int c) {
  return j0 + (c / S::kPiece * S::kGroups + cg) * S::kPiece + c % S::kPiece;
}

// The window of one run, by cp.async (routes kColPieces, kColValues,
// kPanelValues): rows w0 .. w0 + span - 1, columns j0 .. j0 + kCols - 1.
template <class S>
__device__ __forceinline__ void stage_window_async(unsigned char* s_win,
                                                   const typename S::Vec* __restrict__ x,
                                                   int64_t w0, int span, int64_t m, int k,
                                                   int j0, Panels px, int route, int tid) {
  using X = typename S::Vec;
  constexpr int kXB = static_cast<int>(sizeof(X));
  if (route == kColPieces) {
    constexpr int kRowPieces = S::kCols / S::kPiece;
    for (int e = tid; e < span * kRowPieces; e += kBlockThreads) {
      const int r = e / kRowPieces, u = e % kRowPieces;
      const int64_t c = w0 + r;
      const int j = j0 + u * S::kPiece;
      const bool valid = c >= 0 && c < m && j < k;
      copy_async<16>(s_win + window_row<S>(r) + u * 16, valid ? x + c * k + j : x, valid);
    }
  } else if (route == kColValues) {
    for (int e = tid; e < span * S::kCols; e += kBlockThreads) {
      const int r = e / S::kCols, jj = e % S::kCols;
      const int64_t c = w0 + r;
      const bool valid = c >= 0 && c < m && j0 + jj < k;
      copy_async<kXB>(s_win + window_row<S>(r) + jj * kXB, valid ? x + c * k + j0 + jj : x,
                      valid);
    }
  } else {
    // panels: consecutive threads take a column's consecutive rows
    for (int jj = 0; jj < S::kCols; ++jj) {
      const bool col = j0 + jj < k;
      const X* xj = x + static_cast<int64_t>(j0 + jj) * px.B;
      for (int r = tid; r < span; r += kBlockThreads) {
        const int64_t c = w0 + r;
        const bool valid = col && c >= 0 && c < m;
        copy_async<kXB>(s_win + window_row<S>(r) + jj * kXB, valid ? xj + px.at(c) : x, valid);
      }
    }
  }
}

// The window of one run from panels in 16-byte pieces (route kPanelPieces):
// a piece is kPiece consecutive rows of one column, from a row that is a
// multiple of kPiece, loaded into registers and written to its window rows.
// Consecutive threads take a column's consecutive pieces; each thread has
// kBatch loads in flight.
template <class S>
__device__ __forceinline__ void stage_window_pieces(unsigned char* s_win,
                                                    const typename S::Vec* __restrict__ x,
                                                    int64_t w0, int span, int64_t m, int k,
                                                    int j0, Panels px, int tid) {
  using X = typename S::Vec;
  constexpr int P = S::kPiece;
  constexpr int kBatch = S::kBatch;
  const int lead = static_cast<int>(((w0 % P) + P) % P);  // w0 - (the piece row before it)
  const int64_t c_lo = w0 - lead;
  const int n_rp = (lead + span + P - 1) / P;  // pieces a column
  const int total = n_rp * S::kCols;
  for (int e0 = tid; e0 < total; e0 += kBatch * kBlockThreads) {
    X val[kBatch][P];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kBlockThreads;
      const int rp = e % n_rp, j = j0 + e / n_rp;
      const int64_t c = c_lo + static_cast<int64_t>(rp) * P;
      const bool col = e < total && j < k;
      const X* xj = x + static_cast<int64_t>(col ? j : 0) * px.B;
      if (col && c >= 0 && c + P <= m) {
        load_piece(xj + px.at(c), val[b]);
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u)
          val[b][u] = col && c + u >= 0 && c + u < m ? xj[px.at(c + u)] : X(0);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kBlockThreads;
      if (e >= total) break;
      const int rp = e % n_rp, jj = e / n_rp;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int r = rp * P + u - lead;
        if (r >= 0 && r < span)
          *reinterpret_cast<X*>(s_win + window_row<S>(r) + jj * static_cast<int>(sizeof(X))) =
              val[b][u];
      }
    }
  }
}

// One isolated diagonal straight from global memory into the tile, from
// panels (routes kPanelPieces, kPanelValues): rows i .. i + 3 of diagonal
// ``d`` (offset o), x rows i + o .. i + o + 3 of each of the thread's
// columns.  The values come in one piece where that piece lies inside the
// diagonal's stored row.
template <class S>
__device__ __forceinline__ void direct_diagonal(WindowTile<S>& tile,
                                                const typename S::Value* __restrict__ data,
                                                const typename S::Vec* __restrict__ x,
                                                int64_t d, int64_t o, int64_t stride,
                                                int64_t i, int64_t n, int64_t m, int k,
                                                int j0, int cg, Panels px, int route,
                                                bool v_pieces) {
  using X = typename S::Vec;
  X v[kR];
  const auto* row = data + d * stride + i;
  if (v_pieces && i < n && i + kR <= stride) {
    load_values<X>(row, v);
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q) v[q] = i + q < n ? to_x<X>(row[q]) : X(0);
  }
  const int64_t c0 = i + o;
  bool ok[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    ok[q] = c0 + q >= 0 && c0 + q < m;
    if (!ok[q]) v[q] = X(0);
  }
  const bool whole = route == kPanelPieces && c0 >= 0 && c0 + kR <= m && c0 % S::kPiece == 0;
#pragma unroll
  for (int c = 0; c < S::kC; ++c) {
    const int j = tile_column<S>(j0, cg, c);
    const X* xj = x + static_cast<int64_t>(j < k ? j : 0) * px.B;
    if (whole && j < k) {
#pragma unroll
      for (int p = 0; p < kR; p += S::kPiece) {
        X piece[S::kPiece];
        load_piece(xj + px.at(c0 + p), piece);
#pragma unroll
        for (int e = 0; e < S::kPiece; ++e) tile.xr[p + e][c] = piece[e];
      }
    } else {
#pragma unroll
      for (int q = 0; q < kR; ++q) tile.xr[q][c] = ok[q] && j < k ? xj[px.at(c0 + q)] : X(0);
    }
  }
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int c = 0; c < S::kC; ++c) tile.acc[q][c] = fma_x(v[q], tile.xr[q][c], tile.acc[q][c]);
}

// y: rows i .. i + 3 (zeros from row n on, up to rows_out) of this
// thread's columns, in 16-byte pieces where the layout allows.
template <class S>
__device__ __forceinline__ void store_tile(const WindowTile<S>& tile, typename S::Vec* __restrict__ y,
                                           int64_t i, int64_t n, int64_t rows_out, int k,
                                           int j0, int cg, Panels py) {
  using X = typename S::Vec;
  if (i >= rows_out) return;
  const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (py.B == 1) {
    // (n, k) columns (rows_out == n): a piece is kPiece consecutive columns of one row
    const bool pieces = k % S::kPiece == 0 && aligned;
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (i + q >= rows_out) break;
      X* yr = y + (i + q) * k;
#pragma unroll
      for (int h = 0; h < S::kPieces; ++h) {
        const int j = j0 + (h * S::kGroups + cg) * S::kPiece;
        if (pieces) {
          if (j < k) store_piece(yr + j, &tile.acc[q][h * S::kPiece]);
        } else {
#pragma unroll
          for (int e = 0; e < S::kPiece; ++e)
            if (j + e < k) yr[j + e] = tile.acc[q][h * S::kPiece + e];
        }
      }
    }
  } else if (py.B % S::kPiece == 0 && aligned && i + kR <= rows_out) {
    // panels: a piece is kPiece consecutive rows of one column
#pragma unroll
    for (int c = 0; c < S::kC; ++c) {
      const int j = tile_column<S>(j0, cg, c);
      if (j >= k) continue;
#pragma unroll
      for (int q = 0; q < kR; q += S::kPiece) {
        X piece[S::kPiece];
#pragma unroll
        for (int e = 0; e < S::kPiece; ++e) piece[e] = i + q + e < n ? tile.acc[q + e][c] : X(0);
        store_piece(y + py.at(i + q) + static_cast<int64_t>(j) * py.B, piece);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int64_t r = i + q;
      if (r >= rows_out) break;
#pragma unroll
      for (int c = 0; c < S::kC; ++c) {
        const int j = tile_column<S>(j0, cg, c);
        if (j < k) y[py.at(r) + static_cast<int64_t>(j) * py.B] = r < n ? tile.acc[q][c] : X(0);
      }
    }
  }
}

// A run of diagonals d0 .. end - 1 whose offsets lie in [lo, hi]; band:
// consecutive offsets.
struct Run {
  int64_t d0, end, lo, hi;
  bool band;
};

// One block's product: rows i0 .. i0 + kRows - 1, columns j0 .. j0 + kCols
// - 1.  route: how x is staged (XRoute); v_pieces: the value rows are
// 16-byte aligned (data and stride), so the ring copies 16-byte pieces;
// direct (panel routes only): runs of one diagonal skip the window
// (section 4), and the next run's window and ring copies are issued before
// such a diagonal is computed.
template <class S>
__device__ __forceinline__ void window_spmm_block(
    const typename S::Value* __restrict__ data, const typename S::Vec* __restrict__ x,
    const int64_t* __restrict__ offsets, typename S::Vec* __restrict__ y, int64_t D,
    int64_t stride, int64_t n, int64_t m, int k, Panels px, Panels py, int64_t rows_out,
    int64_t i0, int j0, int route, bool v_pieces, bool direct) {
  using V = typename S::Value;
  using X = typename S::Vec;
  extern __shared__ __align__(16) unsigned char smem[];
  V* s_val = reinterpret_cast<V*>(smem);
  int64_t* s_off = reinterpret_cast<int64_t*>(smem + S::kRingBytes);
  unsigned char* s_win = smem + S::kWindowOffset;
  __shared__ long long s_lo, s_hi;  // offset range of the band, then of a run
  __shared__ long long s_end;       // a run's end
  __shared__ int s_band;            // the run's offsets are consecutive
  const int tid = threadIdx.x;
  const int cg = tid % S::kGroups, rg = tid / S::kGroups;
  const int64_t i = i0 + kR * rg;  // this thread's rows: i .. i + 3
  // this thread's first window row and first piece (its h-th piece is G
  // pieces further on)
  const unsigned char* xw = s_win + rg * S::kGroupBytes + cg * 16;
  if (i0 >= n) D = 0;  // a block of padding rows only

  WindowTile<S> tile;
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int c = 0; c < S::kC; ++c) tile.acc[q][c] = X(0);

  // the band's offset range; one run when its window fits
  if (tid == 0) s_lo = LLONG_MAX, s_hi = LLONG_MIN;
  __syncthreads();
  {
    long long lo = LLONG_MAX, hi = LLONG_MIN;
    for (int64_t d = tid; d < D; d += kBlockThreads) {
      const long long o = offsets[d];
      lo = o < lo ? o : lo;
      hi = o > hi ? o : hi;
    }
    if (lo <= hi) atomicMin(&s_lo, lo), atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const bool one_run = D > 0 && s_hi - s_lo + S::kRows <= S::kWindowRows;
  Run whole{0, D, s_lo, s_hi, false};
  if (one_run) {
    bool ok = true;  // offsets[d] == offsets[0] + d
    for (int64_t d = tid; d < D; d += kBlockThreads) ok &= offsets[d] == whole.lo + d;
    whole.band = __syncthreads_and(ok);
  }

  // the run from d0 (block-uniform): the longest whose joint window fits
  auto find = [&](int64_t d0) -> Run {
    if (one_run) return whole;
    __syncthreads();  // the previous run's scalars are read
    if (tid == 0) {
      long long rlo = offsets[d0], rhi = rlo;
      int consecutive = 1;
      int64_t e = d0 + 1;
      for (; e < D; ++e) {
        const long long o = offsets[e];
        const long long nlo = o < rlo ? o : rlo, nhi = o > rhi ? o : rhi;
        if (nhi - nlo + S::kRows > S::kWindowRows) break;
        consecutive &= o == offsets[e - 1] + 1;
        rlo = nlo, rhi = nhi;
      }
      s_lo = rlo, s_hi = rhi, s_end = e, s_band = consecutive;
    }
    __syncthreads();
    return Run{d0, s_end, s_lo, s_hi, s_band != 0};
  };
  auto is_direct = [&](const Run& r) { return direct && r.end == r.d0 + 1; };
  auto n_stages = [&](const Run& r) {
    return static_cast<int>((r.end - r.d0 + S::kDiags - 1) / S::kDiags);
  };
  // the ring: stage s of run r holds diagonals r.d0 + s kDiags .. of this
  // block's rows
  auto load_stage = [&](const Run& r, int s) {
    const int buf = s % S::kStages;
    const int64_t ds = r.d0 + static_cast<int64_t>(s) * S::kDiags;
    V* sv = s_val + buf * S::kStageValues;
    if (v_pieces) {
      constexpr int kPer = 16 / static_cast<int>(sizeof(V));  // values a copy
      constexpr int kChunks = S::kRows / kPer;                // copies a diagonal
      for (int e = tid; e < S::kDiags * kChunks; e += kBlockThreads) {
        const int t = e / kChunks, q = e % kChunks;
        if (ds + t >= r.end) break;
        const int64_t row = i0 + static_cast<int64_t>(q) * kPer;
        const bool valid = row < stride;  // rows past the stored stride read as zero
        copy_async<16>(sv + t * S::kRows + q * kPer,
                       valid ? data + (ds + t) * stride + row : data, valid);
      }
    } else {
      for (int e = tid; e < S::kDiags * S::kRows; e += kBlockThreads) {
        const int t = e / S::kRows, q = e % S::kRows;
        if (ds + t >= r.end) break;
        const int64_t row = i0 + q;
        const bool valid = row < stride;
        if constexpr (sizeof(V) >= 4) {
          copy_async<static_cast<int>(sizeof(V))>(
              sv + t * S::kRows + q, valid ? data + (ds + t) * stride + row : data, valid);
        } else {  // 2-byte values: no cp.async that small
          sv[t * S::kRows + q] = valid ? data[(ds + t) * stride + row] : __float2bfloat16(0.0f);
        }
      }
    }
    if (tid < S::kDiags && ds + tid < r.end)
      copy_async<8>(s_off + buf * S::kDiags + tid, offsets + ds + tid, true);
  };
  // a windowed run's copies: the window by cp.async (joining stage 0's
  // group) and the ring's first kStages - 1 stages
  auto prologue = [&](const Run& r) {
    if (route != kPanelPieces)
      stage_window_async<S>(s_win, x, i0 + r.lo, static_cast<int>(r.hi - r.lo) + S::kRows, m, k,
                            j0, px, route, tid);
#pragma unroll
    for (int s = 0; s < S::kStages - 1; ++s) {
      if (s < n_stages(r)) load_stage(r, s);
      copy_commit();
    }
  };
  // a windowed run's computation, its prologue issued
  auto compute = [&](const Run& r) {
    const int64_t lo = r.lo, hi = r.hi;
    const int64_t w0 = i0 + lo;
    const int span = static_cast<int>(hi - lo) + S::kRows;  // window rows
    // the window in 16-byte pieces through registers, while the ring's
    // copies are in flight
    if (route == kPanelPieces) stage_window_pieces<S>(s_win, x, w0, span, m, k, j0, px, tid);
    // the shift register starts empty: its registers are free above
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int c = 0; c < S::kC; ++c) tile.xr[q][c] = X(0);
    const bool edge = w0 < 0 || i0 + S::kRows - 1 + hi >= m;
    // row i + q's column at relative offset r is i + lo + r + q: in [0, m)
    // for cmin <= r + q < cmax (clamped: r + q lies in [0, span + 3])
    auto clamp_rel = [&](int64_t v) {
      return static_cast<int>(v < -1 ? -1 : v > span + kR ? span + kR : v);
    };
    const int cmin = clamp_rel(-(i + lo)), cmax = clamp_rel(m - (i + lo));
    const int stages = n_stages(r);
    int prev = -2;  // no diagonal before the run's first
    for (int s = 0; s < stages; ++s) {
      copy_wait<S::kStages - 2>();
      __syncthreads();  // stage s has landed; stage s - 1's buffer is free
      if (s + S::kStages - 1 < stages) load_stage(r, s + S::kStages - 1);
      copy_commit();
      const int buf = s % S::kStages;
      const V* sv = s_val + buf * S::kStageValues + kR * rg;
      const int64_t* so = s_off + buf * S::kDiags;
      const int64_t ds = r.d0 + static_cast<int64_t>(s) * S::kDiags;
      const int count = static_cast<int>(r.end - ds < S::kDiags ? r.end - ds : S::kDiags);
      if (r.band && !edge && count == S::kDiags) {
        // a band's offsets are lo + (d - d0): window row d - d0 + q for row q
        tile.band_stage(sv, xw + window_row<S>(static_cast<int>(ds - r.d0)), s == 0);
        prev = static_cast<int>(ds - r.d0) + S::kDiags - 1;
      } else if (edge) {
        tile.template stage<true>(sv, so, count, xw, lo, prev, cmin, cmax);
      } else {
        tile.template stage<false>(sv, so, count, xw, lo, prev, cmin, cmax);
      }
    }
    copy_wait<0>();
    __syncthreads();  // the window and the ring are consumed
  };

  const Run done{D, D, 0, 0, false};
  Run cur = D > 0 ? find(0) : done;
  bool issued = false;  // cur's prologue is issued
  while (cur.d0 < D) {
    if (is_direct(cur)) {
      // the next windowed run's copies fly while this diagonal is computed
      const Run next = cur.end < D ? find(cur.end) : done;
      const bool ahead = next.d0 < D && !is_direct(next);
      if (ahead) prologue(next);
      direct_diagonal<S>(tile, data, x, cur.d0, cur.lo, stride, i, n, m, k, j0, cg, px, route,
                         v_pieces);
      issued = ahead;
      cur = next;
    } else {
      if (!issued) prologue(cur);
      compute(cur);
      issued = false;
      cur = cur.end < D ? find(cur.end) : done;
    }
  }

  store_tile<S>(tile, y, i, n, rows_out, k, j0, cg, py);
}

}  // namespace sigma_dia
