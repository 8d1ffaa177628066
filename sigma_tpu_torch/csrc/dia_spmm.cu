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
// dia_sym_spmm adds the mirror term val(d, i - o) X(j, i - o) for o > 0.
// It replaces PR 2's first version (one thread a row, k accumulators, one
// scalar value load and k scalar x loads a term, each FMA waiting on its
// own load; in (n, k) columns each x load a 4-byte piece of a 32-byte row,
// so a warp's instruction touched 32 sectors for 128 useful bytes).  Its
// bytes are those above, but x is read once a term: on the stencil seven
// times a row, the rows at +-nx^2 from L2, so what sets the pace is the
// L1/L2 traffic and the loads a warp keeps in flight, and through the
// registers that costs, the warps an SM.  It runs dia_spmv.cu's row-tile
// body (dia_tile.cuh) widened from one column to R rows x C columns a
// thread: C = 8 f32 or 4 f64 columns (4 and 2 where k fits half a tile;
// fewer where R is 8), G = ceil(k / C) warps on a row tile, one a column
// group, so no warp computes only zeros past k; one wave of blocks walks
// the tiles, the offsets and value-row bases staged once a block; values
// and x through the read-only path; a batch of diagonals' values loaded
// before the batch's first FMA.  Two tiles, by x's layout:
//
//  * (n, k) columns: R = 4 rows a thread, lane + 32 q of its warp's 128, so
//    a warp's 16-byte load of x reads one piece of 32 consecutive rows (8
//    lines of (n, 8) f32 columns).  With R consecutive rows a thread the
//    same load touches 32 lines, which the L1 serves a line a cycle:
//    x_access_probe.cu (sigma_tpu_torch/tools) measures that pattern at
//    more than twice the time of this one.  So the values are coalesced
//    single values, and x and y rows C / P 16-byte pieces (one value a load
//    where k is not a multiple of P or a vector is not 16-byte aligned);
//    both terms' x of a diagonal are loaded before its first FMA.
//  * Panels (RHS-major, interleaved): R = 16 / sizeof(value) consecutive
//    rows.  The upper term's values are one aligned 16-byte piece, the
//    mirror's the two aligned pieces that hold them (#2's), one value a
//    load where the value rows are not 16-byte aligned; x and y are R / P
//    16-byte pieces of a column (R / P + 1 where o is not a multiple of P).
//    Every place in a piece follows from o mod R, so a chain of branches,
//    uniform over the warp, picks each term's registers at compile time.
//    The upper term's x is used before the mirror's is loaded, and one
//    diagonal's values are loaded at a time: both keep the kernel at 128
//    registers, two blocks of 256 threads an SM.
//
// Not built: x carried in registers along consecutive offsets (the
// stencil's 0, 1 and the mirror's -1).  In columns those rows belong to the
// neighbouring lanes; in panels the carry would hold registers across
// diagonals, and every variant that took registers from the warps an SM
// ran slower; the rows it would save come from L1.  Terms that are not all
// in range (the first and last nx^2 rows, a diagonal at or past n, a
// negative offset) are tested and loaded one by one, as the first version
// did.  Each row's sum is the first version's (ascending stored diagonal,
// the upper term then the mirror term, one FMA each), so y is bit for bit
// its y.

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

#include "dia_tile.cuh"  // dia_window.cuh and the row-tile helpers of dia_spmv.cu

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

// -- dia_sym_spmm: dia_spmv.cu's row-tile body, R rows x C columns a thread --

constexpr int kSymMaxThreads = 256;  // G warps a row tile, at most 8 (bf16 / f64 panels)
constexpr int kSymWarps = 4;         // warps a block where G <= 4
constexpr int kSymChunk = 256;       // offsets and bases staged at once: 4 KB

// one 16-byte piece of x through the read-only data path
__device__ __forceinline__ void ldg_piece(const float* p, float* r) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
}
__device__ __forceinline__ void ldg_piece(const double* p, double* r) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  r[0] = a.x, r[1] = a.y;
}

// One diagonal's values for a thread's R rows, as raw bits: the upper
// val(d, i) and the mirror val(d, i - o), one value a load; mirror(q) is
// row q's.
template <typename V, int R, bool kPieces>
struct SymValues {
  using B = typename Bits<V>::T;
  B u[R], m[R];
  __device__ __forceinline__ B up(int q) const { return u[q]; }
  __device__ __forceinline__ B mirror(int e) const { return m[e]; }
};
// In 16-byte pieces (R consecutive rows, value rows 16-byte aligned): the
// upper piece and #2's two aligned pieces that hold the mirror's R values,
// row q's at mirror(sv + q), sv = (R - o mod R) mod R.
template <typename V, int R>
struct SymValues<V, R, true> {
  using B = typename Bits<V>::T;
  ValuePiece<V> u;
  MirrorPieces<V> m;
  __device__ __forceinline__ B up(int q) const { return u.b[q]; }
  __device__ __forceinline__ B mirror(int e) const { return m.b[e]; }
};

// Columns a thread: C = Cb, or Cb / 2 where k <= Cb / 2.  Cb keeps the
// tile's accumulators at 128 bytes (32 registers) and at most 8 f32 or 4
// f64 columns.
template <typename V, typename X, bool kLane>
constexpr int sym_columns() {
  constexpr int R = kLane ? 4 : rows_of<V>();
  constexpr int cap = sizeof(X) == 8 ? 4 : 8;
  constexpr int fit = 128 / (R * static_cast<int>(sizeof(X)));
  return fit < cap ? fit : cap;
}

// A thread's register tile of #3/#8: R rows x C columns (columns j0 .. j0 +
// C - 1, the first `cols` of them inside k).  kLane (the (n, k) column
// layout): the rows are lane + 32 q of the warp's 128 rows, so one 16-byte
// load of a warp reads 16-byte pieces of 32 consecutive x rows (8 lines of
// (n, 8) f32 columns, not 32), and value loads are coalesced single
// values.  Else (panels): R = 16 / sizeof(value) consecutive rows, whose
// values are one 16-byte piece (kVPieces) and whose x and y in each column
// are R / P 16-byte pieces.
template <typename V, typename X, int C, bool kLane, bool kVPieces>
struct SymTile {
  static constexpr int R = kLane ? 4 : rows_of<V>();
  static constexpr int P = 16 / static_cast<int>(sizeof(X));  // x values a piece
  static constexpr int K = R / P;                             // pieces of a column's R rows
  static constexpr int kStep = kLane ? 32 : 1;                // rows between a thread's two
  static constexpr int kRows = 32 * R;                        // a warp's rows
  // diagonals whose values are loaded before the first FMA of the first:
  // two of the coalesced single values; one of the panels' three pieces
  // (two cost the panels' kernel the registers of a fourth block an SM,
  // and ran slower)
  static constexpr int kBatch = kLane ? 2 : 1;
  static constexpr bool kPieces = !kLane && kVPieces;
  // blocks of 256 threads an SM the registers must allow: 2 (at most 128
  // registers), but 1 for the lane tile of 128 accumulator bytes, whose x
  // of both terms of a diagonal in flight at once (under 200 registers)
  // ran faster than either term's alone under 128 or 168, and 1 for the
  // panels' values one a load (bf16 values spilled under 128)
  static constexpr int kMinBlocks =
      (kLane && R * C * static_cast<int>(sizeof(X)) > 64) || (!kLane && !kVPieces) ? 1 : 2;
  using B = typename Bits<V>::T;
  using Vals = SymValues<V, R, kPieces>;
  static_assert(kLane ? C % P == 0 : R % P == 0, "whole 16-byte pieces of x and y");

  X acc[R][C];
  int64_t i0;  // row q is i0 + q kStep
  int j0;      // first column
  int cols;    // columns inside k, >= 1

  __device__ __forceinline__ SymTile(int64_t base, int lane, int cg, int k) {
    i0 = base + (kLane ? lane : lane * R);
    j0 = cg * C;
    cols = k - j0 < C ? k - j0 : C;
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[q][c] = X(0);
  }

  __device__ __forceinline__ int64_t row(int q) const { return i0 + q * kStep; }

  // the values of diagonal ``row_ptr`` (offset o >= 0, every term in range)
  __device__ __forceinline__ void load_values(Vals& v, const V* row_ptr, int64_t o) const {
    if constexpr (kPieces) {
      v.u.raw = __ldg(reinterpret_cast<const uint4*>(row_ptr + i0));
      const int64_t j = i0 - o;  // >= 0
      const int s = static_cast<int>(j) & (R - 1);
      const uint4* a = reinterpret_cast<const uint4*>(row_ptr + (j - s));
      v.m.raw[0] = __ldg(a);
      v.m.raw[1] = __ldg(s ? a + 1 : a);
    } else {
      const B* r = reinterpret_cast<const B*>(row_ptr);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v.u[q] = __ldg(r + row(q));
        v.m[q] = o > 0 ? __ldg(r + row(q) - o) : B(0);
      }
    }
  }

  // kLane: rows row(q) + s of this thread's columns in the (n, k) column
  // layout: 16-byte pieces of a row's C values (the pieces past k are
  // zeros), else one value a load
  __device__ __forceinline__ void load_rows(X (&xr)[R][C], const X* x, const Panels& p,
                                            int64_t s, bool pieces) const {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const X* a = x + p.at(row(q) + s) + j0;
      if (pieces) {
#pragma unroll
        for (int h = 0; h < C / P; ++h) {
          if (h * P < cols) {
            ldg_piece(a + h * P, &xr[q][h * P]);
          } else {
#pragma unroll
            for (int e = 0; e < P; ++e) xr[q][h * P + e] = X(0);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) xr[q][c] = c < cols ? __ldg(a + c) : X(0);
      }
    }
  }

  // kLane: diagonal o's terms, every one in range; x pieces all loaded
  // before the first FMA
  __device__ __forceinline__ void lane_terms(const Vals& v, const X* x, const Panels& p,
                                             int64_t o, bool pieces) {
    X xu[R][C], xm[R][C];
    load_rows(xu, x, p, o, pieces);
    if (o > 0) load_rows(xm, x, p, -o, pieces);
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[q][c] = fma_x(widen<X>(v.up(q)), xu[q][c], acc[q][c]);
    if (o > 0) {
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[q][c] = fma_x(widen<X>(v.mirror(q)), xm[q][c], acc[q][c]);
    }
  }

  // Panels: diagonal o's terms, every one in range.  i0 is a multiple of
  // R, so with x in 16-byte pieces every place follows from r = o mod R:
  // x[i0 + o] at su of the first piece, x[i0 - o] at sm, val(d, i0 - o) at
  // sv; a chain of branches, uniform over the warp, picks the registers at
  // compile time.  A column's R rows are K pieces (K + 1 where not aligned).
  template <int r>
  __device__ __forceinline__ void panel_terms(int rr, const Vals& v, const X* x, const Panels& p,
                                              int64_t o) {
    if constexpr (r < R - 1) {
      if (rr != r) {
        panel_terms<r + 1>(rr, v, x, p, o);
        return;
      }
    }
    constexpr int su = r % P;
    constexpr int sm = (P - su) % P;
    constexpr int sv = kPieces ? (R - r) % R : 0;
    constexpr int nu = K + (su != 0), nm = K + (sm != 0);
    // the upper term's pieces, then the mirror's: one term's x live at once
    {
      X xb[C][nu * P];
      load_panel_pieces<nu>(xb, x, p, i0 + o - su);
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[q][c] = fma_x(widen<X>(v.up(q)), xb[c][q + su], acc[q][c]);
    }
    if (o > 0) {
      X xb[C][nm * P];
      load_panel_pieces<nm>(xb, x, p, i0 - o - sm);
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[q][c] = fma_x(widen<X>(v.mirror(sv + q)), xb[c][q + sm], acc[q][c]);
    }
  }

  // Panels: the N aligned pieces of each of this thread's columns from row
  // a (a multiple of P) on; zeros past k
  template <int N>
  __device__ __forceinline__ void load_panel_pieces(X (&xb)[C][N * P], const X* x,
                                                    const Panels& p, int64_t a) const {
    int64_t pos[N];  // a piece's place in a panel (interleaved: per 128-row block)
#pragma unroll
    for (int e = 0; e < N; ++e) pos[e] = p.at(a + e * P);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < cols) {
        const X* xc = x + static_cast<int64_t>(j0 + c) * p.B;
#pragma unroll
        for (int e = 0; e < N; ++e) ldg_piece(xc + pos[e], &xb[c][e * P]);
      } else {
#pragma unroll
        for (int e = 0; e < N * P; ++e) xb[c][e] = X(0);
      }
    }
  }

  // Diagonal o's terms tested and loaded one by one, as the first version
  // did: rows past n, a column i + o outside [0, n) and a mirror row i - o
  // before 0 (or o <= 0) are skipped
  __device__ __forceinline__ void careful_terms(const V* row_ptr, const X* x, const Panels& p,
                                                int64_t o, int64_t n) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int64_t i = row(q);
      if (i >= n) continue;
      if (i + o >= 0 && i + o < n) {
        const X v = to_x<X>(row_ptr[i]);
        const X* xr = x + p.at(i + o) + static_cast<int64_t>(j0) * p.B;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c < cols) acc[q][c] = fma_x(v, __ldg(xr + c * p.B), acc[q][c]);
      }
      if (o > 0 && i >= o) {
        const X v = to_x<X>(row_ptr[i - o]);
        const X* xr = x + p.at(i - o) + static_cast<int64_t>(j0) * p.B;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c < cols) acc[q][c] = fma_x(v, __ldg(xr + c * p.B), acc[q][c]);
      }
    }
  }

  // The staged chunk's diagonals in batches: a diagonal whose terms all
  // lie in range (o >= 0, rows row(0) - o and row(R - 1) + o inside [0, n))
  // with x in 16-byte pieces takes the loads above, its values loaded with
  // the batch's; any other is tested term by term.  Each row's sum: the
  // diagonals in stored order, the upper term then the mirror term.
  __device__ __forceinline__ void run(const V* data, const X* x, const Panels& p,
                                      const int64_t* s_off, const int64_t* s_base, int dn,
                                      int64_t n, bool x_pieces) {
    const int64_t lo = row(0), hi = row(R - 1);
    for (int t0 = 0; t0 < dn; t0 += kBatch) {
      Vals v[kBatch];
      bool fast[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        fast[b] = false;
        if (t0 + b < dn) {
          const int64_t o = s_off[t0 + b];
          fast[b] = (kLane || x_pieces) && o >= 0 && lo >= o && hi + o < n;
          if (fast[b]) load_values(v[b], data + s_base[t0 + b], o);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (t0 + b >= dn) break;
        const int64_t o = s_off[t0 + b];
        if (!fast[b]) {
          careful_terms(data + s_base[t0 + b], x, p, o, n);
        } else if constexpr (kLane) {
          lane_terms(v[b], x, p, o, x_pieces);
        } else {
          panel_terms<0>(static_cast<int>(o) & (R - 1), v[b], x, p, o);
        }
      }
    }
  }

  // y: rows below rows_out (zeros from n on: no term touched them), in
  // 16-byte pieces where the layout allows (a row's columns; a column's R
  // rows)
  __device__ __forceinline__ void store(X* y, const Panels& p, int64_t rows_out,
                                        bool pieces) const {
    if constexpr (kLane) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int64_t i = row(q);
        if (i >= rows_out) continue;
        X* yr = y + p.at(i) + j0;
        if (pieces) {
#pragma unroll
          for (int h = 0; h < C / P; ++h)
            if (h * P < cols) store_piece(yr + h * P, &acc[q][h * P]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (c < cols) yr[c] = acc[q][c];
        }
      }
    } else {
      const bool whole = pieces && i0 + R <= rows_out;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= cols) continue;
        X* yc = y + static_cast<int64_t>(j0 + c) * p.B;
        if (whole) {
#pragma unroll
          for (int e = 0; e < K; ++e) {
            X t[P];
#pragma unroll
            for (int u = 0; u < P; ++u) t[u] = acc[e * P + u][c];
            store_piece(yc + p.at(i0 + e * P), t);
          }
        } else {
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (i0 + q < rows_out) yc[p.at(i0 + q)] = acc[q][c];
        }
      }
    }
  }
};

// #3/#8: blocks of G warps a row tile (G = ceil(k / C) column groups, one
// warp each, so no warp computes only columns past k) and kSymWarps / G row
// tiles (one where G > kSymWarps), one wave of them walking the tiles; the
// offsets staged once a block where they fit one chunk.
template <typename V, typename X, int C, bool kLane, bool kVPieces>
__global__ void __launch_bounds__(kSymMaxThreads, (SymTile<V, X, C, kLane, kVPieces>::kMinBlocks))
    dia_sym_spmm_kernel(const V* __restrict__ data, const X* __restrict__ x,
                        const int64_t* __restrict__ offsets, X* __restrict__ y, int64_t D,
                        int64_t stride, int64_t n, int k, int G, Panels p, int64_t rows_out,
                        bool x_pieces, bool y_pieces) {
  using T = SymTile<V, X, C, kLane, kVPieces>;
  __shared__ int64_t s_off[kSymChunk], s_base[kSymChunk];
  const bool one_chunk = D <= kSymChunk;
  if (one_chunk) stage_chunk(s_off, s_base, offsets, 0, static_cast<int>(D), stride);
  const int warp = static_cast<int>(threadIdx.x >> 5), lane = static_cast<int>(threadIdx.x & 31);
  const int per_block = static_cast<int>(blockDim.x >> 5) / G;  // row tiles a block
  const int64_t tiles = (rows_out + T::kRows - 1) / T::kRows;
  const int64_t steps = (tiles + per_block - 1) / per_block;
  for (int64_t t = blockIdx.x; t < steps; t += gridDim.x) {
    T tile((t * per_block + warp / G) * T::kRows, lane, warp % G, k);
    const bool live = tile.row(0) < n;
    for (int64_t d0 = 0; d0 < D; d0 += kSymChunk) {
      const int dn = static_cast<int>(D - d0 < kSymChunk ? D - d0 : kSymChunk);
      if (!one_chunk) stage_chunk(s_off, s_base, offsets, d0, dn, stride);
      if (live) tile.run(data, x, p, s_off, s_base, dn, n, x_pieces);
    }
    tile.store(y, p, rows_out, y_pieces);
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

template <typename V, typename X, int C, bool kLane, bool kVPieces>
cudaError_t launch_sym_c(const void* data, const void* x, const void* offsets, void* y,
                         int64_t D, int64_t stride, int64_t n, int k, Panels p, bool x_pieces,
                         bool y_pieces, int device, cudaStream_t stream) {
  using T = SymTile<V, X, C, kLane, kVPieces>;
  const int G = (k + C - 1) / C;
  const int per_block = G < kSymWarps ? kSymWarps / G : 1;
  const int threads = 32 * G * per_block;
  if (threads > kSymMaxThreads) return cudaErrorInvalidValue;
  auto kernel = dia_sym_spmm_kernel<V, X, C, kLane, kVPieces>;
  static int slots[kSymMaxThreads / 32][64] = {};  // a record for each G
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, threads, device, slots[G - 1], &grid);
  if (err != cudaSuccess) return err;
  const int64_t rows_out = p.rows(n);
  const int64_t tiles = (rows_out + T::kRows - 1) / T::kRows;
  const int64_t steps = (tiles + per_block - 1) / per_block;
  if (steps == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(steps < grid ? steps : grid), threads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, k, G, p, rows_out,
      x_pieces, y_pieces);
  return cudaGetLastError();
}

// The (n, k) column layout takes the lane-rows tile, panels the
// consecutive one; C halved where k fits half a tile; x and y in 16-byte
// pieces where a row's k values (columns) or a panel block (panels) is a
// whole number of pieces and the vector is 16-byte aligned.
template <typename V, typename X>
cudaError_t launch_sym(const void* data, const void* x, const void* offsets, void* y, int64_t D,
                       int64_t stride, int64_t n, int k, Panels p, int device, cudaStream_t s) {
  constexpr int64_t P = 16 / sizeof(X);
  const int64_t unit = p.B == 1 ? k : p.B;
  const bool x_pieces = unit % P == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool y_pieces = unit % P == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (p.B == 1) {
    constexpr int C = sym_columns<V, X, true>();
    return k <= C / 2 ? launch_sym_c<V, X, C / 2, true, false>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s)
                      : launch_sym_c<V, X, C, true, false>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s);
  }
  constexpr int C = sym_columns<V, X, false>();
  const bool vp = value_pieces<V>(data, stride);
  if (k <= C / 2) {
    return vp ? launch_sym_c<V, X, C / 2, false, true>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s)
              : launch_sym_c<V, X, C / 2, false, false>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s);
  }
  return vp ? launch_sym_c<V, X, C, false, true>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s)
            : launch_sym_c<V, X, C, false, false>(data, x, offsets, y, D, stride, n, k, p, x_pieces, y_pieces, device, s);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(vtype, xtype, [&](auto v, auto xv) {
    return launch_sym<decltype(v), decltype(xv)>(data, x, offsets, y, D, stride, n,
                                                 static_cast<int>(k), p, device, s);
  });
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
