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
// are staged in shared memory in chunks, so D is a runtime value and a band
// of any width runs in one launch (the TPU kernel needed VMEM tile picks
// and a chunked wrapper for that).
//
// What bounds them.  SpMV is memory bound: at best each launch reads every
// stored value once and x and y once, D*sizeof(val) + sizeof(x) + sizeof(y)
// bytes per row (36 B/row for the f32 7-point stencil in full storage,
// 24 B/row for its 4 upper diagonals).  The x windows of the D diagonals
// overlap, and at the 10.1M-row north star the largest offset is nx*nx =
// 46,656 rows (186 KB of f32 x), far inside the 50 MB L2, so x comes from
// device memory about once.
//
// All four share one row-tile body (Tile below), built to keep enough
// value bytes in flight to stream at the card's rate:
//
//  * A thread owns R consecutive rows, R = 16 / sizeof(value): one 16-byte
//    piece of each value row (4 f32, 8 bf16 or 2 f64 values), read by one
//    16-byte load where the value rows are 16-byte aligned (data aligned
//    and stride a multiple of R; the port's storage always is, its stride a
//    multiple of 128), else by one load a value.
//  * Diagonals go in batches of a fixed count (8 in 16-byte pieces): all
//    of a batch's value loads are issued before its first FMA, 128 bytes a
//    thread in flight, where the first version (one thread a row, one
//    4-byte value and one x load a step of a runtime loop) had about 8.
//    Their x comes in groups of 128 bytes a thread (8 diagonals' x with f32
//    values and vectors, 4 with bf16 values, 2 with bf16 values and f64
//    vectors).
//  * Offsets and the 64-bit value-row bases d * stride are staged in shared
//    memory once a chunk of diagonals: a value's address is a base plus the
//    thread's first row, with no 64-bit multiply a term.
//  * x.  The R values x[c .. c + R) of a diagonal (c = first row + offset)
//    are read as the 16-byte aligned pieces that hold them (R/P pieces, one
//    more when c is not aligned; P = 16 / sizeof(x)) and shifted into place
//    by selects.  An aligned 16-byte piece that holds an element of x lies
//    inside one page, so the neighbours it brings along cannot fault; they
//    are never selected.  #1 and #2 read x through the read-only data
//    path (on the stencil offsets -1, 0, +1 and +-nx share L1 lines,
//    +-nx^2 come from L2); #5 and #6 from the x window their block
//    staged (below).
//  * A batch whose diagonals keep all of the thread's columns in [0, m)
//    loads its x pieces without a branch; any other batch tests each term.
//  * #1's and #2's blocks stay resident (one wave, sized once a device
//    from the occupancy) and walk the row tiles grid-stride, so offsets
//    that fit one chunk (every stencil, the 245-diagonal band) are staged
//    once a block and no tile waits on a prologue.
//
// Order of each row's sum: ascending diagonal, one fused multiply-add per
// in-range term in the vector type (for #2 the upper term, then the
// mirror term), so y is bit for bit what the first versions (one thread a
// row, `acc += v * x` contracted to an FMA) gave, and #5 and #6 give
// #1's y bit for bit.
//
// The symmetric kernel (#2) is #1 with a second stream for the mirror
// term val(d, i - o) * x[i - o]: a thread's R mirror values are the R
// values of value row d that start o rows before its own, read as the two
// aligned 16-byte pieces that hold them (one where o is a multiple of R,
// as the stencil's nx and nx^2 in f32).  A batch's value pieces, then a
// group's x pieces (upper and mirror), are all loaded before the first
// FMA.  With x 16-byte aligned, every place in a piece (of x[i + o], of
// val(d, i - o), of x[i - o]) follows from o mod R, so a chain of
// branches, uniform over the warp, picks each term's registers at compile
// time (another x alignment shifts by selects).  Shifting each diagonal's
// pieces by selects right after its loads made every diagonal wait on its
// own loads: on an H100 that held the f32 stencil at 0.119 ms and the
// 10.1M-row band of 123 upper diagonals at 2.88 ms, against 0.087 and
// 1.99 ms this way.  The mirror read hits lines that this
// warp loaded a moment ago (a band's offsets of at most 122 rows: L1) or
// that a tile at most 46,656 rows earlier loaded (the stencil's nx^2: 4 x
// 46,656 x 4 B = 746 KB of f32 values and x stream between the two reads,
// far inside the 50 MB L2), so the values come from device memory about
// once.  A value halo staged in shared memory for the small offsets, as
// pruned_sym_spmv (pruned.cu) stages one, was not built: it would replace
// only L1 and L2 hits.  Every row is written exactly once: no atomics and
// no spill between blocks.
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
// Interface.  Plain C entry points bound with ctypes; each makes `device`
// current only when it is not, launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a dtype pair it does not instantiate).

#include "dia_window.cuh"  // cp.async helpers, fma_x, store_piece

namespace {

using namespace sigma_dia;

// -- the row-tile body of #1 and #5 ------------------------------------------

constexpr int kSpmvThreads = 128;     // a block of dia_spmv: a row tile a pass
constexpr int kResidentThreads = 64;  // a block of dia_spmv_resident: one row tile
constexpr int kSpmvChunk = 256;       // offsets and bases staged at once: 4 KB
constexpr int kResidentChunk = 64;    // 1 KB (#6: 1.5 KB) beside a staged window
constexpr int kWindowMaxThreads = 512;  // #6: 1024 rows of f64 values, 2 a thread

// rows a thread: one 16-byte piece of a value row
template <typename V>
__host__ __device__ constexpr int rows_of() {
  return 16 / static_cast<int>(sizeof(V));
}

// diagonals whose values a thread loads before its first FMA: 128 bytes
// in 16-byte pieces; 4 diagonals one value a load (R loads, R addresses each)
template <bool kPieces>
__host__ __device__ constexpr int batch_of() {
  return kPieces ? 8 : 4;
}

// diagonals whose x a thread loads at once: 64 bytes of x, 2 to 4 (all 8
// of a batch at once held the registers of a sixth block an SM and ran
// the f32 stencil 5% slower)
template <typename V, typename X>
__host__ __device__ constexpr int x_batch_of() {
  constexpr int b = 64 / (rows_of<V>() * static_cast<int>(sizeof(X)));
  return b > 4 ? 4 : b < 2 ? 2 : b;
}

template <typename V>
struct Bits;
template <>
struct Bits<float> {
  using T = unsigned;
};
template <>
struct Bits<double> {
  using T = unsigned long long;
};
template <>
struct Bits<__nv_bfloat16> {
  using T = unsigned short;
};

// A thread's R values of one diagonal, kept as raw bits (4 registers for
// any value type) until the FMA widens them.
template <typename V>
union ValuePiece {
  uint4 raw;
  typename Bits<V>::T b[16 / sizeof(V)];
};

template <typename X>
__device__ __forceinline__ X widen(unsigned b) {
  return static_cast<X>(__uint_as_float(b));
}
template <typename X>
__device__ __forceinline__ X widen(unsigned long long b) {
  return static_cast<X>(__longlong_as_double(static_cast<long long>(b)));
}
template <typename X>
__device__ __forceinline__ X widen(unsigned short b) {  // bf16: f32's top half, exact
  return static_cast<X>(__uint_as_float(static_cast<unsigned>(b) << 16));
}

// rows i0 .. i0 + R - 1 of one value row; past n only in the 16-byte form,
// whose piece lies inside the row (stride a multiple of R)
template <typename V, bool kPieces>
__device__ __forceinline__ void load_value_piece(ValuePiece<V>& v, const V* row, int64_t i0,
                                                 int64_t n) {
  if constexpr (kPieces) {
    v.raw = __ldg(reinterpret_cast<const uint4*>(row + i0));
  } else {
    using B = typename Bits<V>::T;
    const B* p = reinterpret_cast<const B*>(row) + i0;
#pragma unroll
    for (int q = 0; q < rows_of<V>(); ++q) v.b[q] = i0 + q < n ? __ldg(p + q) : B(0);
  }
}

// one value or one 16-byte piece of x: from shared memory, or from device
// memory through the read-only data path
template <bool kShared, typename T>
__device__ __forceinline__ T read_x(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}
template <bool kShared>
__device__ __forceinline__ void read_piece(const float* p, float* r) {
  const float4 a = read_x<kShared>(reinterpret_cast<const float4*>(p));
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
}
template <bool kShared>
__device__ __forceinline__ void read_piece(const double* p, double* r) {
  const double2 a = read_x<kShared>(reinterpret_cast<const double2*>(p));
  r[0] = a.x, r[1] = a.y;
}

// out[q] = buf[q + s], q < R, for a runtime s < P (selects)
template <typename X, int R>
__device__ __forceinline__ void shift_x(const X (&buf)[R + 16 / sizeof(X)], int s, X (&out)[R]) {
  constexpr int P = 16 / static_cast<int>(sizeof(X));
#pragma unroll
  for (int q = 0; q < R; ++q) {
    X v = buf[q];
#pragma unroll
    for (int k = 1; k < P; ++k) v = s == k ? buf[q + k] : v;
    out[q] = v;
  }
}

// xr[q] = p[q], q < R, from the aligned 16-byte pieces that hold them
template <bool kShared, typename X, int R>
__device__ __forceinline__ void load_x(const X* p, X (&xr)[R]) {
  constexpr int P = 16 / static_cast<int>(sizeof(X));
  constexpr int K = R / P;
  static_assert(R % P == 0, "a thread's rows are whole pieces of x");
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(X)) & (P - 1);
  const X* a = p - s;
  X buf[R + P];
#pragma unroll
  for (int k = 0; k < K; ++k) read_piece<kShared>(a + k * P, buf + k * P);
  if (s) {
    read_piece<kShared>(a + K * P, buf + K * P);
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e) buf[K * P + e] = X(0);
  }
  shift_x<X, R>(buf, s, xr);
}

// Where a diagonal's x lies: x[j] of diagonal t of the staged chunk at
// at(j, t).  #1 and #2 read x in device memory, #5 its block's one window,
// #6 a window a diagonal inside its tile's pieces.
template <typename X>
struct GlobalX {
  static constexpr bool kShared = false;
  const X* x;
  __device__ __forceinline__ const X* at(int64_t j, int) const { return x + j; }
};
template <typename X>
struct BlockX {  // x[j] at s[j - xlo]
  static constexpr bool kShared = true;
  const X* s;
  int64_t xlo;
  __device__ __forceinline__ const X* at(int64_t j, int) const { return s + (j - xlo); }
};
template <typename X>
struct PieceX {  // x[j] at s[j + rel[t]], rel staged a chunk
  static constexpr bool kShared = true;
  const X* s;
  const int64_t* rel;
  __device__ __forceinline__ const X* at(int64_t j, int t) const { return s + (j + rel[t]); }
};

// The R mirror values of #2 as loaded: the two aligned pieces that hold
// val(d, j0 .. j0 + R), j0 = i0 - o (the second = the first where j0 is
// aligned, so the load needs no branch), and one of them by element.
template <typename V>
union MirrorPieces {
  uint4 raw[2];
  typename Bits<V>::T b[2 * (16 / sizeof(V))];
};

// x[c .. c + R) as the aligned 16-byte pieces that hold them, unshifted:
// R / P pieces from c - s (s = c's place in its piece), then one more
// where s != 0 (else the last again, so the load needs no branch)
template <typename X, int R>
__device__ __forceinline__ void load_x_pieces(const X* p, X (&buf)[R + 16 / sizeof(X)]) {
  constexpr int P = 16 / static_cast<int>(sizeof(X));
  constexpr int K = R / P;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(X)) & (P - 1);
  const X* a = p - s;
#pragma unroll
  for (int k = 0; k < K; ++k) read_piece<false>(a + k * P, buf + k * P);
  read_piece<false>(s ? a + K * P : a + (K - 1) * P, buf + K * P);
}

// The diagonals t0 .. t0 + batch - 1 (those below dn) of a staged chunk:
// values from data + s_base[t] (+ the thread's rows), x from xa.
template <typename V, typename X, bool kPieces, class XAt>
struct Tile {
  static constexpr int R = rows_of<V>();
  static constexpr int kBatch = batch_of<kPieces>();
  static constexpr int kXBatch = x_batch_of<V, X>();
  // #2 loads three value pieces a diagonal (its row and the two that hold
  // the mirror's) and two streams of x: a quarter of the diagonals a batch
  // and one diagonal's x at a time, but half and half with bf16 values (8
  // rows a thread).  Larger batches held the registers of two blocks an
  // SM and ran the f32 stencil 15% slower; smaller ones lost 4% on bf16.
  static constexpr int kSymBatch = R == 8 ? kBatch / 2 : kBatch / 4;
  static constexpr int kSymXBatch = R == 8 ? kXBatch / 2 : 1;
  static constexpr bool kShared = XAt::kShared;
  static_assert(kBatch % kXBatch == 0 && kSymBatch % kSymXBatch == 0, "whole x batches");
  using B = typename Bits<V>::T;
  X acc[R];

  __device__ __forceinline__ Tile() {
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = X(0);
  }

  __device__ __forceinline__ void load_batch(ValuePiece<V> (&v)[kBatch], const V* data,
                                             const int64_t* s_base, int t0, int dn, int64_t i0,
                                             int64_t n) const {
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (t0 + b < dn) load_value_piece<V, kPieces>(v[b], data + s_base[t0 + b], i0, n);
  }

  __device__ __forceinline__ void fma_batch(const ValuePiece<V> (&v)[kBatch], const XAt& xa,
                                            const int64_t* s_off, int t0, int dn, int64_t i0,
                                            int64_t m) {
    bool inside = true;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (t0 + b < dn) {
        const int64_t c = i0 + s_off[t0 + b];
        inside = inside && c >= 0 && c + R <= m;
      }
    }
    if (inside) {
#pragma unroll
      for (int g = 0; g < kBatch; g += kXBatch) {
        X xr[kXBatch][R];
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) {
          const int t = t0 + g + b;
          if (t < dn) load_x<kShared>(xa.at(i0 + s_off[t], t), xr[b]);
        }
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) {
          if (t0 + g + b < dn) {
#pragma unroll
            for (int q = 0; q < R; ++q)
              acc[q] = fma_x(widen<X>(v[g + b].b[q]), xr[b][q], acc[q]);
          }
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int t = t0 + b;
        if (t < dn) {
          const int64_t c = i0 + s_off[t];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            if (c + q >= 0 && c + q < m)
              acc[q] = fma_x(widen<X>(v[b].b[q]), read_x<kShared>(xa.at(c + q, t)), acc[q]);
          }
        }
      }
    }
  }

  // diagonals t0 .. dn - 1 of the staged chunk
  __device__ __forceinline__ void run(const V* data, const XAt& xa, const int64_t* s_off,
                                      const int64_t* s_base, int t0, int dn, int64_t i0,
                                      int64_t n, int64_t m) {
    for (; t0 < dn; t0 += kBatch) {
      ValuePiece<V> v[kBatch];
      load_batch(v, data, s_base, t0, dn, i0, n);
      fma_batch(v, xa, s_off, t0, dn, i0, m);
    }
  }

  // #2: one batch of upper diagonals (offsets o >= 0) of a symmetric n x n
  // matrix, every term of each in this row order: the upper term
  // val(d, i) x[i + o], then for o > 0 the mirror term val(d, i - o)
  // x[i - o].  Where every term of the batch lies inside (columns i + o
  // and rows i - o of all R rows in [0, n)), all value pieces of the batch
  // and then all x pieces of a group are loaded before the first FMA, as
  // the aligned pieces that hold them; else each term is tested and loaded
  // on its own, as the first version did.  xph is x's place in a 16-byte
  // piece (0 when x is 16-byte aligned).
  __device__ __forceinline__ void sym_batch(const V* data, const X* x, int xph,
                                            const int64_t* s_off, const int64_t* s_base, int t0,
                                            int dn, int64_t i0, int64_t n) {
    constexpr int P = 16 / static_cast<int>(sizeof(X));
    bool inside = true;
#pragma unroll
    for (int b = 0; b < kSymBatch; ++b) {
      if (t0 + b < dn) {
        const int64_t o = s_off[t0 + b];
        inside = inside && o >= 0 && i0 + o + R <= n && i0 >= o;
      }
    }
    if (inside) {
      ValuePiece<V> vu[kSymBatch];
      MirrorPieces<V> vm[kSymBatch];
#pragma unroll
      for (int b = 0; b < kSymBatch; ++b) {
        if (t0 + b < dn) {
          const V* row = data + s_base[t0 + b];
          const int64_t j0 = i0 - s_off[t0 + b];  // >= 0
          load_value_piece<V, kPieces>(vu[b], row, i0, n);
          if constexpr (kPieces) {
            const int s = static_cast<int>(j0) & (R - 1);
            const uint4* a = reinterpret_cast<const uint4*>(row + (j0 - s));
            vm[b].raw[0] = __ldg(a);
            vm[b].raw[1] = __ldg(s ? a + 1 : a);
          } else {
#pragma unroll
            for (int q = 0; q < R; ++q) vm[b].b[q] = __ldg(reinterpret_cast<const B*>(row) + j0 + q);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kSymBatch; g += kSymXBatch) {
        X xu[kSymXBatch][R + P], xm[kSymXBatch][R + P];
#pragma unroll
        for (int b = 0; b < kSymXBatch; ++b) {
          if (t0 + g + b < dn) {
            const int64_t o = s_off[t0 + g + b];
            load_x_pieces<X, R>(x + (i0 + o), xu[b]);
            load_x_pieces<X, R>(x + (i0 - o), xm[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kSymXBatch; ++b) {
          if (t0 + g + b < dn) {
            const int64_t o = s_off[t0 + g + b];
            if (kPieces && xph == 0) {
              sym_terms_at<0>(static_cast<int>(o) & (R - 1), o > 0, vu[g + b], vm[g + b], xu[b],
                              xm[b]);
            } else {
              sym_terms(o, xph, vu[g + b], vm[g + b], xu[b], xm[b]);
            }
          }
        }
      }
    } else {
      for (int b = 0; b < kSymBatch && t0 + b < dn; ++b) {
        const B* row = reinterpret_cast<const B*>(data + s_base[t0 + b]);
        const int64_t o = s_off[t0 + b];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int64_t i = i0 + q;
          if (i >= n) continue;
          // the lower bound only keeps a (rejected) negative offset from
          // reading before x
          if (i + o >= 0 && i + o < n) acc[q] = fma_x(widen<X>(__ldg(row + i)), __ldg(x + i + o), acc[q]);
          if (o > 0 && i >= o) acc[q] = fma_x(widen<X>(__ldg(row + i - o)), __ldg(x + i - o), acc[q]);
        }
      }
    }
  }

  // One diagonal's terms in the 16-byte value form with x 16-byte aligned:
  // every place in a piece follows from r = o mod R (i0 is a multiple of R
  // and P divides R), so each value and x is picked at compile time.  The
  // chain of r's is uniform over a warp.
  template <int r>
  __device__ __forceinline__ void sym_terms_at(int rr, bool mirror, const ValuePiece<V>& vu,
                                               const MirrorPieces<V>& vm,
                                               const X (&xu)[R + 16 / sizeof(X)],
                                               const X (&xm)[R + 16 / sizeof(X)]) {
    constexpr int P = 16 / static_cast<int>(sizeof(X));
    if constexpr (r < R - 1) {
      if (rr != r) {
        sym_terms_at<r + 1>(rr, mirror, vu, vm, xu, xm);
        return;
      }
    }
    constexpr int su = r % P;            // x[i0 + o]'s place
    constexpr int sv = (R - r) % R;      // val(d, i0 - o)'s place
    constexpr int sm = (P - r % P) % P;  // x[i0 - o]'s place
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = fma_x(widen<X>(vu.b[q]), xu[q + su], acc[q]);
    if (mirror) {
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = fma_x(widen<X>(vm.b[sv + q]), xm[q + sm], acc[q]);
    }
  }

  // The same for any x alignment or value form: the places at run time
  __device__ __forceinline__ void sym_terms(int64_t o, int xph, const ValuePiece<V>& vu,
                                            const MirrorPieces<V>& vm,
                                            const X (&xu)[R + 16 / sizeof(X)],
                                            const X (&xm)[R + 16 / sizeof(X)]) {
    constexpr int P = 16 / static_cast<int>(sizeof(X));
    X xr[R];
    shift_x<X, R>(xu, static_cast<int>(xph + o) & (P - 1), xr);
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = fma_x(widen<X>(vu.b[q]), xr[q], acc[q]);
    if (o > 0) {
      shift_x<X, R>(xm, static_cast<int>(xph - o) & (P - 1), xr);
      const int sv = kPieces ? static_cast<int>(-o) & (R - 1) : 0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        B v = vm.b[q];
#pragma unroll
        for (int k = 1; k < R; ++k) v = sv == k ? vm.b[q + k] : v;
        acc[q] = fma_x(widen<X>(v), xr[q], acc[q]);
      }
    }
  }

  __device__ __forceinline__ void store(X* y, int64_t i0, int64_t n) const {
    constexpr int P = 16 / static_cast<int>(sizeof(X));
    if (i0 + R <= n) {
#pragma unroll
      for (int k = 0; k < R / P; ++k) store_piece(y + i0 + k * P, acc + k * P);
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (i0 + q < n) y[i0 + q] = acc[q];
    }
  }
};

// Stage offsets[d0 : d0 + dn] and their value-row bases (whole block).
__device__ __forceinline__ void stage_chunk(int64_t* s_off, int64_t* s_base,
                                            const int64_t* __restrict__ offsets, int64_t d0,
                                            int dn, int64_t stride) {
  __syncthreads();
  for (int t = threadIdx.x; t < dn; t += blockDim.x) {
    s_off[t] = offsets[d0 + t];
    s_base[t] = (d0 + t) * stride;
  }
  __syncthreads();
}

// Blocks stay resident (one wave) and walk the row tiles grid-stride, so
// offsets of at most one chunk (every stencil and the 245-diagonal band)
// are staged once a block, not once a tile.
template <typename V, typename X, bool kPieces>
__global__ void __launch_bounds__(kSpmvThreads)
    dia_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                    const int64_t* __restrict__ offsets, X* __restrict__ y, int64_t D,
                    int64_t stride, int64_t n, int64_t m) {
  using T = Tile<V, X, kPieces, GlobalX<X>>;
  constexpr int64_t kTile = kSpmvThreads * T::R;
  __shared__ int64_t s_off[kSpmvChunk], s_base[kSpmvChunk];
  const bool one_chunk = D <= kSpmvChunk;
  if (one_chunk) stage_chunk(s_off, s_base, offsets, 0, static_cast<int>(D), stride);
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x * T::R;
    T tile;
    for (int64_t d0 = 0; d0 < D; d0 += kSpmvChunk) {
      const int dn = static_cast<int>(D - d0 < kSpmvChunk ? D - d0 : kSpmvChunk);
      if (!one_chunk) stage_chunk(s_off, s_base, offsets, d0, dn, stride);
      if (i0 < n) tile.run(data, GlobalX<X>{x}, s_off, s_base, 0, dn, i0, n, m);
    }
    if (i0 < n) tile.store(y, i0, n);
  }
}

// #2: #1's blocks and walk, each batch through Tile::sym_batch.
template <typename V, typename X, bool kPieces>
__global__ void __launch_bounds__(kSpmvThreads)
    dia_sym_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                        const int64_t* __restrict__ offsets, X* __restrict__ y, int64_t D,
                        int64_t stride, int64_t n) {
  using T = Tile<V, X, kPieces, GlobalX<X>>;
  constexpr int64_t kTile = kSpmvThreads * T::R;
  __shared__ int64_t s_off[kSpmvChunk], s_base[kSpmvChunk];
  const bool one_chunk = D <= kSpmvChunk;
  if (one_chunk) stage_chunk(s_off, s_base, offsets, 0, static_cast<int>(D), stride);
  // x's place in a 16-byte piece
  const int xph = static_cast<int>(reinterpret_cast<uintptr_t>(x) / sizeof(X)) &
                  (16 / static_cast<int>(sizeof(X)) - 1);
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x * T::R;
    T tile;
    for (int64_t d0 = 0; d0 < D; d0 += kSpmvChunk) {
      const int dn = static_cast<int>(D - d0 < kSpmvChunk ? D - d0 : kSpmvChunk);
      if (!one_chunk) stage_chunk(s_off, s_base, offsets, d0, dn, stride);
      if (i0 < n) {
        for (int t0 = 0; t0 < dn; t0 += T::kSymBatch)
          tile.sym_batch(data, x, xph, s_off, s_base, t0, dn, i0, n);
      }
    }
    if (i0 < n) tile.store(y, i0, n);
  }
}

// The 16-byte value form: data aligned and every value row a whole number
// of a thread's pieces.
template <typename V>
bool value_pieces(const void* data, int64_t stride) {
  return reinterpret_cast<uintptr_t>(data) % 16 == 0 && stride % rows_of<V>() == 0;
}

// The blocks of `kernel` (`threads` a block, no dynamic shared memory) that
// fit on `device` at once; asked once a device, `slots` is the caller's
// record (one a kernel instantiation).
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int device, int (&slots)[64], int* out) {
  const bool known = device >= 0 && device < 64;
  if (known && slots[device] > 0) {
    *out = slots[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (known) slots[device] = *out;
  return cudaSuccess;
}

template <typename V, typename X, bool kPieces>
cudaError_t launch_full(const void* data, const void* x, const void* offsets, void* y,
                        int64_t D, int64_t stride, int64_t n, int64_t m, int device,
                        cudaStream_t stream) {
  constexpr int64_t rows = kSpmvThreads * rows_of<V>();
  auto kernel = dia_spmv_kernel<V, X, kPieces>;
  static int slots[64] = {};
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, kSpmvThreads, device, slots, &grid);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + rows - 1) / rows;
  kernel<<<static_cast<unsigned>(tiles < grid ? tiles : grid), kSpmvThreads, 0, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m);
  return cudaGetLastError();
}

template <typename V, typename X, bool kPieces>
cudaError_t launch_sym(const void* data, const void* x, const void* offsets, void* y, int64_t D,
                       int64_t stride, int64_t n, int device, cudaStream_t stream) {
  constexpr int64_t rows = kSpmvThreads * rows_of<V>();
  auto kernel = dia_sym_spmv_kernel<V, X, kPieces>;
  static int slots[64] = {};
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, kSpmvThreads, device, slots, &grid);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + rows - 1) / rows;
  kernel<<<static_cast<unsigned>(tiles < grid ? tiles : grid), kSpmvThreads, 0, stream>>>(
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
// dia_spmv_resident takes x of up to 57,600 f32 / 28,800 f64 values
// (ops/spmv_dia.py STAGED_SMEM_BYTES), the route of the JAX package's
// VMEM-resident body.  The first version copied the whole x into every
// block; on this card a whole-x stage per block has no reason to exist:
// L2 holds x, and a block reads only its window.  So each block, one row
// tile of 64 threads x R rows, stages the columns its rows read,
// [max(0, i0 + min offset), min(m, i0 + T + max offset)) (at most m
// values, so it always fits where the route sends x; for a band exactly
// the columns it needs), from the aligned 16-byte piece that holds the
// first, in 16-byte cp.async pieces (the last one partial: the copy
// zero-fills past m).  The block's first batch of values is prefetched
// into L2 before it waits for the window, so the two overlap.  Then the
// row-tile body above runs with x from shared memory.
//
// dia_spmv_window is #5 with the one window cut into pieces: per tile of T
// rows starting at row t0 (T / R threads), the union of the diagonals' x
// windows [t0 + o, t0 + o + T) as disjoint pieces (ops/spmv_dia.py
// window_plan with align = P: piece starts and shared-memory bases
// multiples of P = 16 / sizeof(x), so column c lies at an index = c mod
// P and a piece's columns copy in aligned 16-byte cp.async pieces; one
// value a copy where x itself is not 16-byte aligned).  Columns outside
// [0, m) are not copied: the body never selects them.  Each diagonal's
// place in its piece is staged with the offsets and row bases, then the
// row-tile body runs with x from shared memory.  One window of T + span
// values, as the TPU kernel copied, does not fit for the 3-D stencil
// (span 93,312 at nx=216); the union does (1,200 values for T = 256).

// one 16-byte piece of x into shared memory, `bytes` of it read (the rest
// zero-filled)
__device__ __forceinline__ void copy_piece(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// (64, 8): at most 128 registers, which every instantiation fits without
// a spill (ptxas' own pick spilled a few bytes in some)
template <typename V, typename X, bool kPieces>
__global__ void __launch_bounds__(kResidentThreads, 8)
    dia_spmv_resident_kernel(const V* __restrict__ data, const X* __restrict__ x,
                             const int64_t* __restrict__ offsets, X* __restrict__ y,
                             int64_t D, int64_t stride, int64_t n, int64_t m, int64_t o_lo,
                             int64_t o_hi) {
  using T = Tile<V, X, kPieces, BlockX<X>>;
  constexpr int P = 16 / static_cast<int>(sizeof(X));
  constexpr int64_t kTile = kResidentThreads * T::R;
  extern __shared__ __align__(16) unsigned char smem[];
  X* s_x = reinterpret_cast<X*>(smem);
  __shared__ int64_t s_off[kResidentChunk], s_base[kResidentChunk];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t i0 = t0 + threadIdx.x * T::R;
  // the window: columns [w0, w1), staged from xlo, the first column of the
  // aligned piece that holds w0 (s_x[j - xlo] = x[j])
  const int64_t w0 = t0 + o_lo > 0 ? t0 + o_lo : 0;
  const int64_t w1 = t0 + kTile + o_hi < m ? t0 + kTile + o_hi : m;
  const int64_t xlo = w0 - static_cast<int64_t>((reinterpret_cast<uintptr_t>(x + w0) / sizeof(X)) &
                                                (P - 1));
  for (int64_t c = xlo + threadIdx.x * P; c < w1; c += kResidentThreads * P) {
    const int64_t left = w1 - c;
    copy_piece(s_x + (c - xlo), x + c, static_cast<int>((left < P ? left : P) * sizeof(X)));
  }
  copy_commit();
  const bool live = i0 < n;
  T tile;
  int dn = static_cast<int>(D < kResidentChunk ? D : kResidentChunk);
  stage_chunk(s_off, s_base, offsets, 0, dn, stride);
  // the first batch's values on their way into L2 while the window lands
  if (live) {
    for (int t = 0; t < dn && t < T::kBatch; ++t)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(data + s_base[t] + i0));
  }
  copy_wait<0>();
  __syncthreads();
  if (live) tile.run(data, BlockX<X>{s_x, xlo}, s_off, s_base, 0, dn, i0, n, m);
  for (int64_t d0 = kResidentChunk; d0 < D; d0 += kResidentChunk) {
    dn = static_cast<int>(D - d0 < kResidentChunk ? D - d0 : kResidentChunk);
    stage_chunk(s_off, s_base, offsets, d0, dn, stride);
    if (live) tile.run(data, BlockX<X>{s_x, xlo}, s_off, s_base, 0, dn, i0, n, m);
  }
  if (live) tile.store(y, i0, n);
}

// Stage offsets[d0 : d0 + dn], their value-row bases and, for #6, where
// each diagonal's window of the tile at row t0 lies: x[j] at s_x[j + rel[t]]
// (pos from window_plan).
__device__ __forceinline__ void stage_window_chunk(int64_t* s_off, int64_t* s_base,
                                                   int64_t* s_rel,
                                                   const int64_t* __restrict__ offsets,
                                                   const int64_t* __restrict__ pos, int64_t d0,
                                                   int dn, int64_t stride, int64_t t0) {
  __syncthreads();
  for (int t = threadIdx.x; t < dn; t += blockDim.x) {
    const int64_t o = offsets[d0 + t];
    s_off[t] = o;
    s_base[t] = (d0 + t) * stride;
    s_rel[t] = pos[d0 + t] - o - t0;
  }
  __syncthreads();
}

// #6: one row tile of `tile_rows` rows a block (tile_rows / R threads), its
// window's pieces staged, then #1's row-tile body with x from them.
template <typename V, typename X, bool kPieces>
__global__ void __launch_bounds__(kWindowMaxThreads)
    dia_spmv_window_kernel(const V* __restrict__ data, const X* __restrict__ x,
                           const int64_t* __restrict__ offsets, X* __restrict__ y,
                           const int64_t* __restrict__ plan, int64_t D, int64_t stride,
                           int64_t n, int64_t m, int64_t pieces, int64_t tile_rows) {
  using T = Tile<V, X, kPieces, PieceX<X>>;
  constexpr int P = 16 / static_cast<int>(sizeof(X));
  extern __shared__ __align__(16) unsigned char smem[];
  X* s_x = reinterpret_cast<X*>(smem);
  __shared__ int64_t s_off[kResidentChunk], s_base[kResidentChunk], s_rel[kResidentChunk];
  const int64_t* starts = plan;                // pieces, multiples of P
  const int64_t* bases = plan + pieces;        // pieces + 1, multiples of P
  const int64_t* pos = plan + 2 * pieces + 1;  // D
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t i0 = t0 + threadIdx.x * T::R;
  // piece p: columns [t0 + starts[p], + its length) at s_x[bases[p]] on,
  // those inside [0, m) copied: whole 16-byte pieces where x is 16-byte
  // aligned (the last partial, zero-filled past m), else one value a copy
  const bool x_pieces = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int64_t p = 0; p < pieces; ++p) {
    const int64_t c0 = t0 + starts[p], b = bases[p];
    const int64_t lo = c0 > 0 ? c0 : 0;
    const int64_t end = c0 + bases[p + 1] - b;
    const int64_t hi = end < m ? end : m;
    if (x_pieces) {
      for (int64_t c = lo + threadIdx.x * P; c < hi; c += blockDim.x * P) {
        const int64_t left = hi - c;
        copy_piece(s_x + b + (c - c0), x + c, static_cast<int>((left < P ? left : P) * sizeof(X)));
      }
    } else {
      for (int64_t c = lo + threadIdx.x; c < hi; c += blockDim.x)
        copy_async<sizeof(X)>(s_x + b + (c - c0), x + c, true);
    }
  }
  copy_commit();
  const bool live = i0 < n;
  T tile;
  int dn = static_cast<int>(D < kResidentChunk ? D : kResidentChunk);
  stage_window_chunk(s_off, s_base, s_rel, offsets, pos, 0, dn, stride, t0);
  // the first batch's values on their way into L2 while the window lands
  if (live) {
    for (int t = 0; t < dn && t < T::kBatch; ++t)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(data + s_base[t] + i0));
  }
  copy_wait<0>();
  __syncthreads();
  if (live) tile.run(data, PieceX<X>{s_x, s_rel}, s_off, s_base, 0, dn, i0, n, m);
  for (int64_t d0 = kResidentChunk; d0 < D; d0 += kResidentChunk) {
    dn = static_cast<int>(D - d0 < kResidentChunk ? D - d0 : kResidentChunk);
    stage_window_chunk(s_off, s_base, s_rel, offsets, pos, d0, dn, stride, t0);
    if (live) tile.run(data, PieceX<X>{s_x, s_rel}, s_off, s_base, 0, dn, i0, n, m);
  }
  if (live) tile.store(y, i0, n);
}

// Opt a kernel in to `bytes` of dynamic shared memory on `device`, once
// for each larger size: `done` is the caller's record (one a kernel
// instantiation) of the largest size set so far on each device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int device, size_t (&done)[64]) {
  const bool known = device >= 0 && device < 64;
  if (known && bytes <= done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess && known) done[device] = bytes;
  return err;
}

template <typename V, typename X, bool kPieces>
cudaError_t launch_resident(const void* data, const void* x, const void* offsets, void* y,
                            int64_t D, int64_t stride, int64_t n, int64_t m, int64_t o_lo,
                            int64_t o_hi, int device, cudaStream_t stream) {
  constexpr int64_t P = 16 / sizeof(X);
  constexpr int64_t kTile = kResidentThreads * rows_of<V>();
  // the longest window: at most T + span and at most m columns, from the
  // aligned piece that holds its first, in whole pieces
  const int64_t cols = kTile + o_hi - o_lo < m ? kTile + o_hi - o_lo : m;
  const size_t bytes = static_cast<size_t>((cols + 2 * P - 1) / P * P) * sizeof(X);
  auto kernel = dia_spmv_resident_kernel<V, X, kPieces>;
  static size_t done[64] = {};
  cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile), kResidentThreads, bytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m, o_lo, o_hi);
  return cudaGetLastError();
}

template <typename V, typename X, bool kPieces>
cudaError_t launch_window(const void* data, const void* x, const void* offsets, void* y,
                          int64_t D, int64_t stride, int64_t n, int64_t m, const void* plan,
                          int64_t pieces, int64_t tile_rows, int64_t length, int device,
                          cudaStream_t stream) {
  if (tile_rows < 32 || tile_rows > 1024 || tile_rows % 32) return cudaErrorInvalidValue;
  auto kernel = dia_spmv_window_kernel<V, X, kPieces>;
  const size_t bytes = static_cast<size_t>(length) * sizeof(X);
  static size_t done[64] = {};
  cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + tile_rows - 1) / tile_rows);
  kernel<<<grid, static_cast<unsigned>(tile_rows / rows_of<V>()), bytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y),
      static_cast<const int64_t*>(plan), D, stride, n, m, pieces, tile_rows);
  return cudaGetLastError();
}

// Make `device` current unless it is.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// f(V{}, X{}) for the instantiated (value, vector) pair of the dtype codes
template <class F>
cudaError_t by_dtype(int vtype, int xtype, F&& f) {
  if (xtype == kF32) {
    if (vtype == kF32) return f(float{}, float{});
    if (vtype == kBF16) return f(__nv_bfloat16{}, float{});
  } else if (xtype == kF64) {
    if (vtype == kF64) return f(double{}, double{});
    if (vtype == kF32) return f(float{}, double{});
    if (vtype == kBF16) return f(__nv_bfloat16{}, double{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sigma_dia_spmv(int device, int vtype, int xtype, const void* data,
                              const void* x, const void* offsets, void* y,
                              int64_t D, int64_t stride, int64_t n, int64_t m,
                              void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(vtype, xtype, [&](auto v, auto xv) {
    using V = decltype(v);
    using X = decltype(xv);
    return value_pieces<V>(data, stride)
               ? launch_full<V, X, true>(data, x, offsets, y, D, stride, n, m, device, s)
               : launch_full<V, X, false>(data, x, offsets, y, D, stride, n, m, device, s);
  });
}

extern "C" int sigma_dia_sym_spmv(int device, int vtype, int xtype,
                                  const void* data, const void* x,
                                  const void* offsets, void* y, int64_t D,
                                  int64_t stride, int64_t n, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(vtype, xtype, [&](auto v, auto xv) {
    using V = decltype(v);
    using X = decltype(xv);
    return value_pieces<V>(data, stride)
               ? launch_sym<V, X, true>(data, x, offsets, y, D, stride, n, device, s)
               : launch_sym<V, X, false>(data, x, offsets, y, D, stride, n, device, s);
  });
}

// (..., D, stride, n, m, o_lo, o_hi: the least and greatest offset, stream)
extern "C" int sigma_dia_spmv_resident(int device, int vtype, int xtype, const void* data,
                                       const void* x, const void* offsets, void* y,
                                       int64_t D, int64_t stride, int64_t n, int64_t m,
                                       int64_t o_lo, int64_t o_hi, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(vtype, xtype, [&](auto v, auto xv) {
    using V = decltype(v);
    using X = decltype(xv);
    return value_pieces<V>(data, stride)
               ? launch_resident<V, X, true>(data, x, offsets, y, D, stride, n, m, o_lo, o_hi,
                                             device, s)
               : launch_resident<V, X, false>(data, x, offsets, y, D, stride, n, m, o_lo, o_hi,
                                              device, s);
  });
}

extern "C" int sigma_dia_spmv_window(int device, int vtype, int xtype, const void* data,
                                     const void* x, const void* offsets, void* y,
                                     int64_t D, int64_t stride, int64_t n, int64_t m,
                                     const void* plan, int64_t pieces, int64_t tile_rows,
                                     int64_t length, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(vtype, xtype, [&](auto v, auto xv) {
    using V = decltype(v);
    using X = decltype(xv);
    return value_pieces<V>(data, stride)
               ? launch_window<V, X, true>(data, x, offsets, y, D, stride, n, m, plan, pieces,
                                           tile_rows, length, device, s)
               : launch_window<V, X, false>(data, x, offsets, y, D, stride, n, m, plan, pieces,
                                            tile_rows, length, device, s);
  });
}
