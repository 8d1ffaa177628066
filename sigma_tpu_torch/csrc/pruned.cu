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
// tile_ptr[t] .. tile_ptr[t+1], the active ones first in ascending offset
// order, then zero slots of offset 0 that pad the tile to a multiple of the
// group; tile_end[t] ends the active ones.  TR is a multiple of 1024.  The
// TPU kernel's flat grid carried a tile's sum across its steps in VMEM and
// needed a haloed x frame, window rolls and first-step flags; here a block
// owns its rows outright, so nothing carries between blocks.
//
// The SpMV kernels (pruned_spmv, pruned_sym_spmv).  What bounds them is
// device memory: the active slots' values once, x and y once (1.50 GB of
// f32 values for the full plan of the 10,092,544-row mesh, 0.77 GB for the
// symmetric one, and 80 MB of x and y).  A block owns kRows = 1024
// consecutive rows of one tile and walks tile_ptr[t] .. tile_end[t]: the
// padding slots are not streamed.  The design keeps many bytes in flight
// on each SM:
//   - one producer warp streams each slot's segment for the block, kRows *
//     sizeof(V) contiguous bytes, through a ring of shared-memory stages
//     with TMA bulk copies (cp.async.bulk, completion on an mbarrier, an L2
//     evict-first hint but for the rows the next block reads again); 32-40
//     KB are in flight per block and three or four blocks per SM;
//   - eight consumer warps own four rows a thread, interleaved by 256 so
//     shared-memory reads are conflict-free, and release each stage on a
//     second mbarrier;
//   - x[i0 + omin, i0 + kRows + omax), the window of the tile's offsets
//     around the block's first row i0, is staged once per block in 16-byte
//     pieces, clamped at 0 and m, and every slot reads x from there;
//   - inside the block the indices are 32-bit (tile-local rows, int32
//     offsets in shared memory); the 64-bit base is one per slot, in the
//     producer; a block whose rows and window lie inside the matrix runs
//     its slot loop without per-row masks.
// The symmetric kernel stages d[r0 - H, r0 + kRows) of each slot, H the
// tile's largest mirror offset rounded up to 16, so the upper term d[r] and
// the mirror term d[r - om] both come from shared memory: each value is
// read from device memory once per block, the H halo rows a second time
// (from L2 when they are still there) by the next block.  The mirror's x,
// x[i - om + sym_shift], lies in the same staged window.  The mirror terms
// whose source row lies in tile t - 1 (om > r; the plan keeps the reach
// under one tile) stay a gather from device memory, no atomics, done only
// by the blocks within spill_rows of the tile start.  A block whose x
// window or value stages would not fit shared memory (a tile reach of
// about 500 rows or more) walks the same slots in the same order with
// plain loads.  Measured on an H100 (PERF.md, Findings): the full
// kernel streams its active bytes at about 90% of the copy rate; the
// symmetric one at about 80%, held by the halo re-read and the two terms'
// work per row (its bf16-values form is not twice as fast).
//
// The SpMM kernels (pruned_spmm, pruned_sym_spmm).  What bounds them is
// device memory too: the active slots' values once for all k panels, the k
// x panels read and the k y panels written once (at k = 8 on the
// 10,092,544-row mesh 1.50 GB of f32 values and 0.65 GB of panels for the
// full plan, 0.77 GB and 0.65 GB for the symmetric one).  Every FMA needs
// its x operand from on-chip memory, k of them for each value streamed,
// so x must cost little more than a byte of shared memory a FMA.  The
// design is the SpMVs' block walk on dia_window.cuh's staged window and
// register tile:
//   - a block of 256 threads owns S::kRows = 1024 / G consecutive rows of
//     one tile and walks tile_ptr[t] .. tile_end[t], the tile's active
//     slots, four a ring stage: each slot's segment (for the symmetric
//     kernel with its halo of H rows, so that the mirror term d[r - om]
//     comes from the same stage) in 16-byte cp.async pieces from all
//     threads, three stages, two in flight, one barrier a stage.  The
//     full kernel's first stages fly while the block reduces its offsets.
//     (A TMA ring with a producer warp, as the SpMVs', leaves 96 registers
//     a thread at two blocks an SM; fed from inside a 256-thread block it
//     streamed slower than pruned_spmv on the same slots.)
//   - a thread holds a register tile of 4 consecutive rows x C columns (C
//     = 8 with f32 vectors, 4 with f64), G = ceil(k / C) threads side by
//     side on one group of rows (at least 2 with 8-byte values, whose
//     1024-row stages would crowd out the window);
//   - the x window [i0 + lo, i0 + kRows + hi) of all of the block's
//     columns is staged once per block (lo .. hi the tile's offsets, for
//     the symmetric kernel also its mirror columns sym_shift - om), zeros
//     outside [0, m) and past k, in dia_window.cuh's padded, conflict-free
//     window rows: from (m, k) columns by its cp.async routes, from
//     RHS-major panels one value a cp.async, a warp covering whole window
//     rows (stage_x);
//   - x is carried along runs of consecutive offsets (an RCM band's active
//     offsets come in a few such runs a tile): the tile's shift register
//     takes one new window row a slot, 16 or 32 bytes for 4 C FMAs; a gap
//     reloads the four rows (the symmetric kernel with f64 vectors reads
//     each slot's four rows afresh: the shift register's registers would
//     spill there).  The mirror term reads its four x rows afresh (its
//     runs go the other way) and its four values one a load;
//   - y is stored from the tile in 16-byte pieces where the layout allows
//     (store_tile), the symmetric kernel's rows past n into the spill.
// Tile t - 1's mirror terms, taken by the blocks within spill_rows of the
// tile start after their own slots, come from the last Hp rows of its
// slots and Hp rows of x, staged in the freed ring and window (a gather
// from device memory where they do not fit).  A block whose window or halo
// would not fit shared memory walks the same slots in the same order on
// the same register tile with plain loads.  Two blocks an SM (128
// registers a thread, 108 KB of shared memory) for every dtype pair and k.

// Symmetric storage.  The mirror term of row i is
//     A[i, i - om] = d_s[i - om]  times  x[i - om + sym_shift]
// for every slot s with mirror offset om = offsets[s] - sym_shift > 0
// whose source row i - om lies in s's tile.  The plan widens the tile
// until the band's reach fits one tile (om < TR), so the source row lies
// in the row's own tile t or in t - 1: row i walks tile t's slots (upper
// and mirror terms) and tile t - 1's slots (mirror terms with
// om > i - t*TR; a block skips tile t - 1 when its first row is at least
// spill_rows = halo*128 > om past the tile start).  The TPU kernel
// instead scattered each tile's mirror into a per-tile spill block that an
// XLA pass added to the next tile.  Rows n .. n + spill_rows are computed
// too when a spill is asked for and take the mirror terms only.
//
// Order of the sums and masks.  Each row sums in slot order; the
// symmetric kernels add, per slot, the upper term and then the mirror
// term, then tile t - 1's mirror terms; one FMA a term in the vector type
// X.  Skipping the padding removes only + 0 * x terms.  Out-of-range terms
// (column outside [0, m), mirror source before the tile) are skipped or
// selected away (value and x 0), never multiplied by zero.  The five
// (value, vector) dtype pairs of the DIA kernels.
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k, a
// panel-block length, a tile height or a data pointer it does not take.

#include <climits>

#include "dia_window.cuh"

namespace {

using namespace sigma_dia;

// ---- the SpMV kernels (#10, #12): TMA value ring, staged x -----------------

constexpr int kRows = 1024;               // rows of a block; divides every TR
constexpr int kWarps = 8;                 // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kPer = kRows / kConsumers;  // rows of a consumer thread
constexpr int kBlock = kConsumers + 32;   // and one producer warp
constexpr int kMaxStages = 16;
constexpr int kRingBytes = 32768;         // value stages of pruned_spmv
constexpr int kSymRingBytes = 40960;      // of pruned_sym_spmv (with the halo)
constexpr int kWindow = 2048;             // staged x elements
constexpr int kFar = 1 << 30;             // bounds |column - first row| in int

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and expect `bytes` from the copies that complete on `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_normal_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// one TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ int clamp_far(int64_t v) {
  return v > kFar ? kFar : v < -kFar ? -kFar : static_cast<int>(v);
}

// a barrier of the consumer warps alone (the producer does not wait)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// a value load that streams past L1 and is evicted first (the plain-load walk)
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) { return __ldcs(p); }

// The least and greatest of offsets[s0, s0 + ns), in every thread of a
// block of kThreadsB threads (s_red: three ints a warp; the warps' maxima
// of offsets[p0, p0 + np) stay in its last third).
template <int kThreadsB>
__device__ __forceinline__ void offset_range(const int64_t* __restrict__ offsets, int64_t s0,
                                             int ns, int* s_red, int& lo, int& hi,
                                             int64_t p0 = 0, int np = 0) {
  int a = INT_MAX, b = INT_MIN, b2 = INT_MIN;
  for (int c = threadIdx.x; c < ns; c += kThreadsB) {
    const int o = static_cast<int>(offsets[s0 + c]);
    a = min(a, o);
    b = max(b, o);
  }
  for (int c = threadIdx.x; c < np; c += kThreadsB) b2 = max(b2, static_cast<int>(offsets[p0 + c]));
  a = __reduce_min_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  b2 = __reduce_max_sync(0xffffffffu, b2);
  constexpr int W = kThreadsB / 32;
  if ((threadIdx.x & 31) == 0) {
    s_red[threadIdx.x >> 5] = a;
    s_red[W + (threadIdx.x >> 5)] = b;
    s_red[2 * W + (threadIdx.x >> 5)] = b2;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
  for (int w = 0; w < W; ++w) {
    lo = min(lo, s_red[w]);
    hi = max(hi, s_red[W + w]);
  }
}

// Initialise the stage barriers (full: the producer's arrival and the
// bytes; empty: one arrival per consumer warp) and return, in every thread
// of the block, the least and greatest of offsets[s0, s0 + ns).
__device__ __forceinline__ void block_setup(const int64_t* __restrict__ offsets, int64_t s0,
                                            int ns, uint64_t* full, uint64_t* empty,
                                            int* s_red, int& lo, int& hi) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  offset_range<kBlock>(offsets, s0, ns, s_red, lo, hi);
}

// The x window: xs[j] = x[g0 + j] for j < len (len and g0 multiples of
// 16 / sizeof(X)), 0 outside [0, m); 16-byte pieces where they lie inside.
template <typename X>
__device__ __forceinline__ void stage_window(X* xs, const X* __restrict__ x, int64_t g0,
                                             int len, int64_t m) {
  constexpr int E = 16 / sizeof(X);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int p = threadIdx.x; p < len / E; p += kConsumers) {
    const int64_t g = g0 + static_cast<int64_t>(p) * E;
    if (vec && g >= 0 && g + E <= m) {
      *reinterpret_cast<uint4*>(xs + p * E) = __ldg(reinterpret_cast<const uint4*>(x + g));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) xs[p * E + e] = (g + e >= 0 && g + e < m) ? x[g + e] : X(0);
    }
  }
}

// The producer: lane 0 of the last warp copies rows [first, r0 + kRows) of
// slots s0 .. s0 + ns into the ring's stages (stage st at ring + st *
// stride + skip), waiting for the consumers to free a stage before reusing
// it.  The last `tail` rows, which the block below reads again as its halo,
// keep the normal L2 policy; the rest are evicted first.
template <typename V>
__device__ __forceinline__ void produce(V* ring, const V* __restrict__ data, int64_t TR,
                                        int64_t s0, int ns, int first, int r0, int stride,
                                        int skip, int tail, int stages, uint64_t* full,
                                        uint64_t* empty) {
  if ((threadIdx.x & 31) != 0) return;
  const uint64_t stream = evict_first_policy(), keep = evict_normal_policy();
  const int rows = r0 + kRows - first;
  tail = min(tail, rows);
  const uint32_t head_bytes = static_cast<uint32_t>((rows - tail) * sizeof(V));
  const uint32_t tail_bytes = static_cast<uint32_t>(tail * sizeof(V));
  const V* src = data + s0 * TR + first;
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < ns; ++c) {
    if (c >= stages) mbar_wait(&empty[st], ph ^ 1);
    mbar_expect_tx(&full[st], head_bytes + tail_bytes);
    V* dst = ring + st * stride + skip;
    const V* from = src + static_cast<int64_t>(c) * TR;
    if (head_bytes) bulk_load(dst, from, head_bytes, &full[st], stream);
    if (tail_bytes) bulk_load(dst + rows - tail, from + rows - tail, tail_bytes, &full[st], keep);
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
}

// Release a ring stage (each consumer warp arrives once) and step to the next.
__device__ __forceinline__ void release(uint64_t* empty, int stages, int& st, uint32_t& ph) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
  if (++st == stages) {
    st = 0;
    ph ^= 1;
  }
}

// pruned_spmv's terms of slots s_off[0, cn) from the ring, for a consumer
// thread's rows; xs[col - wlo] is x[i0 + col].  kMasked checks each column
// against [0, m) (clo .. chi); a block whose x window lies inside needs no
// check.
template <bool kMasked, typename V, typename X>
__device__ __forceinline__ void full_chunk(X (&acc)[kPer], const V* ring, const X* xs,
                                           const int* s_off, int cn, int wlo, int clo, int chi,
                                           uint64_t* full, uint64_t* empty, int stages, int& st,
                                           uint32_t& ph) {
  const int tid = threadIdx.x;
  for (int c = 0; c < cn; ++c) {
    const int o = s_off[c];
    mbar_wait(&full[st], ph);
    const V* v = ring + st * kRows;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = tid + j * kConsumers;
      const int col = r + o;
      if (!kMasked || (col >= clo && col < chi)) acc[j] += to_x<X>(v[r]) * xs[col - wlo];
    }
    release(empty, stages, st, ph);
  }
}

// pruned_sym_spmv's terms of slots s_off[0, cn) from the ring: per slot the
// upper term, then the mirror term (om > 0) from the same stage; v[r] of a
// stage holds tile row r0 + r, for r >= -H.  kMasked checks the rows (upper
// terms for rows below n; mirror sources in the tile, om <= r0 + r) and the
// columns; a block inside all of them needs no check.
template <bool kMasked, typename V, typename X>
__device__ __forceinline__ void sym_chunk(X (&acc)[kPer], const V* ring, const X* xs,
                                          const int* s_off, int cn, int wlo, int clo, int chi,
                                          int r0, int64_t upper_rows, int sym_shift, int H,
                                          int stride, uint64_t* full, uint64_t* empty,
                                          int stages, int& st, uint32_t& ph) {
  const int tid = threadIdx.x;
  for (int c = 0; c < cn; ++c) {
    const int o = s_off[c];
    const int om = o - sym_shift;
    mbar_wait(&full[st], ph);
    const V* v = ring + st * stride + H;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = tid + j * kConsumers;
      const int col = r + o;
      if (!kMasked || (r < upper_rows && col >= clo && col < chi))
        acc[j] += to_x<X>(v[r]) * xs[col - wlo];
      const int src = r - om + sym_shift;
      if (om > 0 && (!kMasked || (om <= r0 + r && src >= clo && src < chi)))
        acc[j] += to_x<X>(v[r - om]) * xs[src - wlo];
    }
    release(empty, stages, st, ph);
  }
}

template <typename V, typename X>
__global__ void __launch_bounds__(kBlock, 3)
    pruned_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ tile_ptr,
                       const int64_t* __restrict__ tile_end, X* __restrict__ y, int64_t TR,
                       int64_t n, int64_t m) {
  constexpr int kStages = kRingBytes / (kRows * static_cast<int>(sizeof(V)));
  static_assert(kStages >= 2 && kStages <= kMaxStages, "ring stages");
  constexpr int E = 16 / sizeof(X);
  extern __shared__ __align__(128) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  X* xs = reinterpret_cast<X*>(smem + kRingBytes);
  __shared__ int s_off[kOffsetChunk];
  __shared__ int s_red[3 * kBlock / 32];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];

  const int64_t per_tile = TR / kRows;
  const int64_t t = blockIdx.x / per_tile;
  const int r0 = static_cast<int>(blockIdx.x % per_tile) * kRows;  // tile-local
  const int64_t i0 = t * TR + r0;                                   // global
  const int64_t s0 = tile_ptr[t];
  const int ns = static_cast<int>(tile_end[t] - s0);
  int lo, hi;
  block_setup(offsets, s0, ns, full, empty, s_red, lo, hi);
  // x window [wlo, wlo + wlen) relative to i0: columns r + o, r < kRows
  int wlo = 0, wlen = 0;
  if (ns > 0) {
    wlo = lo & ~(E - 1);
    wlen = (hi + kRows - wlo + E - 1) & ~(E - 1);
  }
  const bool staged = ns > 0 && wlen <= kWindow;
  if (threadIdx.x >= kConsumers) {
    if (staged) produce(ring, data, TR, s0, ns, r0, r0, kRows, 0, 0, kStages, full, empty);
    return;
  }

  const int tid = threadIdx.x;
  if (staged) stage_window(xs, x, i0 + wlo, wlen, m);
  // column i0 + c lies in [0, m) for c in [clo, chi)
  const int clo = clamp_far(-i0);
  const int chi = clamp_far(m - i0);
  const bool masked = wlo < clo || wlo + wlen > chi;
  X acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = X(0);
  int st = 0;
  uint32_t ph = 0;
  for (int c0 = 0; c0 < ns; c0 += kOffsetChunk) {
    const int cn = min(kOffsetChunk, ns - c0);
    consumers_sync();
    for (int c = tid; c < cn; c += kConsumers) s_off[c] = static_cast<int>(offsets[s0 + c0 + c]);
    consumers_sync();
    if (staged && masked) {
      full_chunk<true>(acc, ring, xs, s_off, cn, wlo, clo, chi, full, empty, kStages, st, ph);
    } else if (staged) {
      full_chunk<false>(acc, ring, xs, s_off, cn, wlo, clo, chi, full, empty, kStages, st, ph);
    } else {
      for (int c = 0; c < cn; ++c) {
        const int o = s_off[c];
        const V* v = data + (s0 + c0 + c) * TR + r0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int r = tid + j * kConsumers;
          const int col = r + o;
          if (col >= clo && col < chi) acc[j] += to_x<X>(ld_stream(v + r)) * x[i0 + col];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = tid + j * kConsumers;
    if (r < n - i0) y[i0 + r] = acc[j];
  }
}

template <typename V, typename X>
__global__ void __launch_bounds__(kBlock, 3)
    pruned_sym_spmv_kernel(const V* __restrict__ data, const X* __restrict__ x,
                           const int64_t* __restrict__ offsets,
                           const int64_t* __restrict__ tile_ptr,
                           const int64_t* __restrict__ tile_end, X* __restrict__ y,
                           X* __restrict__ spill, int64_t TR, int64_t G, int64_t n, int64_t m,
                           int sym_shift, int spill_rows, int64_t rows_out) {
  constexpr int E = 16 / sizeof(X);
  extern __shared__ __align__(128) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  X* xs = reinterpret_cast<X*>(smem + kSymRingBytes);
  __shared__ int s_off[kOffsetChunk];
  __shared__ int s_red[3 * kBlock / 32];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];

  const int64_t per_tile = TR / kRows;
  const int64_t t = blockIdx.x / per_tile;  // G for spill rows past the last tile
  const int r0 = static_cast<int>(blockIdx.x % per_tile) * kRows;
  const int64_t i0 = t * TR + r0;
  const int64_t s0 = t < G ? tile_ptr[t] : 0;
  const int ns = t < G ? static_cast<int>(tile_end[t] - s0) : 0;
  int lo, hi;
  block_setup(offsets, s0, ns, full, empty, s_red, lo, hi);
  // the tile's largest mirror offset, and the stage halo H >= it: a stage
  // holds rows r0 - H .. r0 + kRows of one slot
  const int hm = ns > 0 ? max(hi - sym_shift, 0) : 0;
  const int H = (hm + 15) & ~15;
  const int stride = kRows + H;
  const int stages = min(kMaxStages, kSymRingBytes / (stride * static_cast<int>(sizeof(V))));
  // x window: upper columns r + o and mirror sources r - om + sym_shift
  int wlo = 0, wlen = 0;
  if (ns > 0) {
    const int a = hm > 0 ? min(lo, sym_shift - hm) : lo;
    const int b = hm > 0 ? max(hi, sym_shift) : hi;
    wlo = a & ~(E - 1);
    wlen = (b + kRows - wlo + E - 1) & ~(E - 1);
  }
  const bool staged = ns > 0 && stages >= 2 && wlen <= kWindow;
  if (threadIdx.x >= kConsumers) {
    if (staged) {
      const int first = max(r0 - H, 0);  // rows before the tile are not copied
      produce(ring, data, TR, s0, ns, first, r0, stride, first - (r0 - H), H, stages, full,
              empty);
    }
    return;
  }

  const int tid = threadIdx.x;
  if (staged) stage_window(xs, x, i0 + wlo, wlen, m);
  const int clo = clamp_far(-i0);
  const int chi = clamp_far(m - i0);
  const int64_t upper_rows = n - i0;  // rows r < upper_rows take upper terms
  const bool masked = wlo < clo || wlo + wlen > chi || upper_rows < kRows || r0 < H;
  X acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = X(0);
  int st = 0;
  uint32_t ph = 0;
  for (int c0 = 0; c0 < ns; c0 += kOffsetChunk) {
    const int cn = min(kOffsetChunk, ns - c0);
    consumers_sync();
    for (int c = tid; c < cn; c += kConsumers) s_off[c] = static_cast<int>(offsets[s0 + c0 + c]);
    consumers_sync();
    if (staged && masked) {
      sym_chunk<true>(acc, ring, xs, s_off, cn, wlo, clo, chi, r0, upper_rows, sym_shift, H,
                      stride, full, empty, stages, st, ph);
    } else if (staged) {
      sym_chunk<false>(acc, ring, xs, s_off, cn, wlo, clo, chi, r0, upper_rows, sym_shift, H,
                       stride, full, empty, stages, st, ph);
    } else {
      for (int c = 0; c < cn; ++c) {
        const int o = s_off[c];
        const int om = o - sym_shift;
        const V* v = data + (s0 + c0 + c) * TR + r0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int r = tid + j * kConsumers;
          const int col = r + o;
          if (r < upper_rows && col >= clo && col < chi)
            acc[j] += to_x<X>(ld_stream(v + r)) * x[i0 + col];
          const int src = r - om + sym_shift;
          if (om > 0 && om <= r0 + r && src >= clo && src < chi)
            acc[j] += to_x<X>(v[r - om]) * x[i0 + src];
        }
      }
    }
  }
  if (t >= 1 && t - 1 < G && r0 < spill_rows) {
    // tile t - 1: the mirror terms whose source row lies there (om > r0 +
    // r), a gather; the slots' loads are independent, so several are in
    // flight at once
    const int64_t p0 = tile_ptr[t - 1];
    const int np = static_cast<int>(tile_end[t - 1] - p0);
    for (int c0 = 0; c0 < np; c0 += kOffsetChunk) {
      const int cn = min(kOffsetChunk, np - c0);
      consumers_sync();
      for (int c = tid; c < cn; c += kConsumers)
        s_off[c] = static_cast<int>(offsets[p0 + c0 + c]) - sym_shift;
      consumers_sync();
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        const int om = s_off[c];
        // v[r - om] holds tile t - 1's row TR + r0 + r - om
        const V* v = data + (p0 + c0 + c) * TR + TR + r0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int r = tid + j * kConsumers;
          const int src = r - om + sym_shift;
          if (om > r0 + r && src >= clo && src < chi)
            acc[j] += to_x<X>(v[r - om]) * x[i0 + src];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = i0 + tid + j * kConsumers;
    if (i < n)
      y[i] = acc[j];
    else if (i < rows_out)
      spill[i - n] = acc[j];
  }
}

// Allow `kernel` `smem` bytes of dynamic shared memory once per device;
// `done` is the caller's own record (one per kernel instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int device, bool (&done)[64]) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <typename V, typename X>
cudaError_t launch_spmv(const void* data, const void* x, const void* offsets,
                        const void* tile_ptr, const void* tile_end, void* y, int64_t TR,
                        int64_t n, int64_t m, int device, cudaStream_t stream) {
  const int smem = kRingBytes + kWindow * static_cast<int>(sizeof(X));
  auto kernel = pruned_spmv_kernel<V, X>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kernel, smem, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((n + kRows - 1) / kRows), kBlock, smem, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(tile_ptr),
      static_cast<const int64_t*>(tile_end), static_cast<X*>(y), TR, n, m);
  return cudaGetLastError();
}

template <typename V, typename X>
cudaError_t launch_sym_spmv(const void* data, const void* x, const void* offsets,
                            const void* tile_ptr, const void* tile_end, void* y, void* spill,
                            int64_t TR, int64_t G, int64_t n, int64_t m, int sym_shift,
                            int spill_rows, int64_t rows_out, int device, cudaStream_t stream) {
  const int smem = kSymRingBytes + kWindow * static_cast<int>(sizeof(X));
  auto kernel = pruned_sym_spmv_kernel<V, X>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kernel, smem, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((rows_out + kRows - 1) / kRows), kBlock, smem, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(tile_ptr),
      static_cast<const int64_t*>(tile_end), static_cast<X*>(y), static_cast<X*>(spill), TR, G,
      n, m, sym_shift, spill_rows, rows_out);
  return cudaGetLastError();
}

// ---- the SpMM kernels (#11, #13): staged x window and register tile ---------
// ---- (dia_window.cuh), cp.async value ring --------------------------------

constexpr int kSpmmSmem = 110592;  // dynamic shared memory of an SpMM block: two an SM
constexpr int kSpmmStages = 3;     // value ring stages, two in flight

// An SpMM block's shape for value type V, vector type X and G column groups
// (the members dia_window.cuh's window, tile and store read): 4 rows x C
// columns a thread, 1024 / G rows a block; ring stages of kR = 4 slots
// (one register-tile phase each) of kRows rows, and for the symmetric
// kernel up to kHaloCap rows of halo before them; the window in the rest of
// kSpmmSmem.
template <typename V, typename X, int G, bool kSym>
struct SpmmShape {
  using Value = V;
  using Vec = X;
  static constexpr int kGroups = G;
  static constexpr int kRows = kR * kBlockThreads / G;              // rows a block
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(X));  // x values a 16-byte piece
  static constexpr int kC = sizeof(X) == 8 ? 4 : 8;                // columns a thread
  static constexpr int kPieces = kC / kPiece;
  static constexpr int kCols = G * kC;                             // columns a block
  static constexpr int kRowBytes = kCols * static_cast<int>(sizeof(X));
  static constexpr int kGroupBytes = kR * kRowBytes + 16 * G;      // 4 window rows + padding
  static constexpr int kHaloCap = kSym ? (sizeof(V) == 8 ? 128 : 256) : 0;
  // x carried along the offsets in the tile's shift register; not in the
  // symmetric kernel with f64 vectors, whose registers it would spill
  static constexpr bool kCarry = !(kSym && sizeof(X) == 8);
  static constexpr int kStageValues = kR * (kRows + kHaloCap);
  static constexpr int kRingBytes = kSpmmStages * kStageValues * static_cast<int>(sizeof(V));
  static constexpr int kSmemBytes = kSpmmSmem;
  static constexpr int kWindowRows = (kSmemBytes - kRingBytes) / kGroupBytes * kR;
  static_assert(kRingBytes % 16 == 0 && kWindowRows > kRows, "ring and window");
};

// Four values v[a .. a + 3] of a ring stage (any a), widened to X: one
// value a load.  (Two aligned 16-byte pieces shifted by selects read half
// the shared-memory wavefronts with f32 values, but their registers made
// ptxas spill in the symmetric kernel.)
template <typename X, typename V>
__device__ __forceinline__ void load_shifted(const V* v, int a, X (&out)[kR]) {
#pragma unroll
  for (int e = 0; e < kR; ++e) out[e] = to_x<X>(v[a + e]);
}

// Rows q of the thread += v[q] x[window row rel + q] (xw: the thread's
// first window row and piece), each x row read afresh.
template <class S>
__device__ __forceinline__ void fma_rows(WindowTile<S>& tile, const typename S::Vec (&v)[kR],
                                         const unsigned char* xw, int rel) {
  using X = typename S::Vec;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const X* p = reinterpret_cast<const X*>(xw + window_row<S>(rel + q));
#pragma unroll
    for (int h = 0; h < S::kPieces; ++h) {
      X piece[S::kPiece];
      load_piece(p + h * S::kGroups * S::kPiece, piece);
#pragma unroll
      for (int e = 0; e < S::kPiece; ++e) {
        X& acc = tile.acc[q][h * S::kPiece + e];
        acc = fma_x(v[q], piece[e], acc);
      }
    }
  }
}

// The mirror term of one slot from its ring stage: rows q of the thread
// (block rows rr + q) += v[rr + q - om] x[window row mrel + q].  kMasked
// drops the terms whose source row lies before the tile (om > r0 + rr + q:
// tile t - 1's pass takes them) or whose column lies outside [0, m).
template <bool kMasked, class S>
__device__ __forceinline__ void mirror_term(WindowTile<S>& tile, const typename S::Value* v,
                                            const unsigned char* xw, int rr, int om, int mrel,
                                            int r0, int clo, int chi, int sym_shift) {
  using X = typename S::Vec;
  X mv[kR];
  load_shifted<X>(v, rr - om, mv);
  if (kMasked) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int src = rr + q - om + sym_shift;
      if (om > r0 + rr + q || src < clo || src >= chi) mv[q] = X(0);
    }
  }
  fma_rows<S>(tile, mv, xw, mrel);
}

// The x window [w0, w0 + span) of all the block's columns from panels
// (RHS-major x) by cp.async of single values, zeros outside [0, m) and
// past k.  A warp covers whole window rows, lane l column l mod kCols of
// row l / kCols, so its shared-memory writes are conflict-free.  Columns
// (m, k) go through dia_window.cuh's routes.
template <class S>
__device__ __forceinline__ void stage_x(unsigned char* s_win, const typename S::Vec* __restrict__ x,
                                        int64_t w0, int span, int64_t m, int k, Panels px,
                                        int route, int tid) {
  using X = typename S::Vec;
  constexpr int kXB = static_cast<int>(sizeof(X));
  if (route != kPanelValues) {
    stage_window_async<S>(s_win, x, w0, span, m, k, 0, px, route, tid);
    return;
  }
  for (int e = tid; e < span * S::kCols; e += kBlockThreads) {
    const int r = e / S::kCols, j = e % S::kCols;
    const int64_t c = w0 + r;
    const bool valid = j < k && c >= 0 && c < m;
    copy_async<kXB>(s_win + window_row<S>(r) + j * kXB,
                    valid ? x + static_cast<int64_t>(j) * px.B + px.at(c) : x, valid);
  }
}

// One ring stage: slots j0 .. j0 + cnt of the block, cnt <= 4, each its
// rows [first, r0 + kRows) at stage row skip + ... (stride values a slot),
// in 16-byte cp.async pieces from all threads, and their offsets.
template <class S>
__device__ __forceinline__ void load_stage(typename S::Value* sv, int* so,
                                           const typename S::Value* __restrict__ src,
                                           const int64_t* __restrict__ offsets, int64_t TR,
                                           int j0, int cnt, int rows, int stride, int skip,
                                           int tid) {
  using V = typename S::Value;
  constexpr int P = 16 / static_cast<int>(sizeof(V));  // values a piece
  const int pieces = rows / P;
  for (int e = tid; e < cnt * pieces; e += kBlockThreads) {
    const int t = e / pieces, q = e - t * pieces;
    copy_async<16>(sv + t * stride + skip + q * P, src + (j0 + t) * TR + q * P, true);
  }
  if (tid < cnt) so[tid] = static_cast<int>(offsets[j0 + tid]);
}

// The slots of one ring stage (sv: slot t's block row r at sv[t * stride +
// H + r], r >= -H; so: their offsets): per slot the upper term (x carried
// along consecutive offsets: the slot of phase t reads window rows rel ..
// rel + 3 for rows 0 .. 3), then for the symmetric kernel the mirror term.
// kMasked selects away the terms whose column lies outside [0, m) (clo ..
// chi, relative to the block's first row), the upper terms of rows n and
// past, and the mirror terms whose source lies before the tile.
template <bool kMasked, bool kSym, class S>
__device__ __forceinline__ void spmm_stage(WindowTile<S>& tile, const typename S::Value* sv,
                                           const int* so, int cnt, const unsigned char* xw,
                                           int wlo, int clo, int chi, int rr, int r0,
                                           int upper_rows, int sym_shift, int H, int stride,
                                           int& prev) {
  using V = typename S::Value;
  using X = typename S::Vec;
#pragma unroll
  for (int t = 0; t < kR; ++t) {  // t: the shift register's phase
    if (t >= cnt) return;
    const int o = so[t];
    const int rel = o - wlo;
    const V* v = sv + t * stride + H;
    X vv[kR];
    load_values<X>(v + rr, vv);
    if (kMasked) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int col = rr + q + o;
        if (col < clo || col >= chi || (kSym && rr + q >= upper_rows)) vv[q] = X(0);
      }
    }
    if constexpr (S::kCarry) {
      if (rel == prev + 1) {
        // rows 0 .. 2 take rows 1 .. 3's x of the slot before
        tile.load_row((t + kR - 1) % kR, xw, rel + kR - 1);
      } else {
#pragma unroll
        for (int q = 0; q < kR; ++q) tile.load_row((t + q) % kR, xw, rel + q);
      }
      prev = rel;
      tile.fma_tile(t, vv);
    } else {
      fma_rows<S>(tile, vv, xw, rel);
    }
    if constexpr (kSym) {
      const int om = o - sym_shift;
      if (om > 0)
        mirror_term<kMasked, S>(tile, v, xw, rr, om, sym_shift - om - wlo, r0, clo, chi,
                                sym_shift);
    }
  }
}

// The same slots with plain loads (a block whose window or stages do not
// fit): values from d (block row r of slot c at d[c * TR + r]), x from the
// panels; the same terms in the same order.
template <bool kSym, class S>
__device__ __forceinline__ void spmm_plain(WindowTile<S>& tile,
                                           const typename S::Value* __restrict__ d,
                                           const typename S::Vec* __restrict__ x,
                                           const int* s_off, int cn, int64_t TR, int64_t i0,
                                           int clo, int chi, int rr, int r0, int upper_rows,
                                           int sym_shift, int k, int cg, Panels px) {
  using V = typename S::Value;
  using X = typename S::Vec;
  for (int c = 0; c < cn; ++c) {
    const int o = s_off[c];
    const V* v = d + c * TR;
    X vv[kR];
    load_values<X>(v + rr, vv);
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int col = rr + q + o;
      if (col < clo || col >= chi || (kSym && rr + q >= upper_rows)) continue;
      const X* xc = x + px.at(i0 + col);
#pragma unroll
      for (int e = 0; e < S::kC; ++e) {
        const int j = tile_column<S>(0, cg, e);
        if (j < k) tile.acc[q][e] = fma_x(vv[q], xc[static_cast<int64_t>(j) * px.B], tile.acc[q][e]);
      }
    }
    const int om = o - sym_shift;
    if (kSym && om > 0) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int r = rr + q, src = r - om + sym_shift;
        if (om > r0 + r || src < clo || src >= chi) continue;
        const X mv = to_x<X>(v[r - om]);
        const X* xc = x + px.at(i0 + src);
#pragma unroll
        for (int e = 0; e < S::kC; ++e) {
          const int j = tile_column<S>(0, cg, e);
          if (j < k) tile.acc[q][e] = fma_x(mv, xc[static_cast<int64_t>(j) * px.B], tile.acc[q][e]);
        }
      }
    }
  }
}

// Tile t - 1's mirror terms (source row before the tile, om > r0 + r): a
// gather from device memory; d + c * TR + r - om holds tile t - 1's row
// TR + r0 + r - om of slot c, s_om[c] its mirror offset.
template <class S>
__device__ __forceinline__ void spmm_prev_tile(WindowTile<S>& tile,
                                               const typename S::Value* __restrict__ d,
                                               const typename S::Vec* __restrict__ x,
                                               const int* s_om, int cn, int64_t TR, int64_t i0,
                                               int clo, int chi, int rr, int r0, int sym_shift,
                                               int k, int cg, Panels px) {
  using X = typename S::Vec;
#pragma unroll 4
  for (int c = 0; c < cn; ++c) {
    const int om = s_om[c];
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int r = rr + q, src = r - om + sym_shift;
      if (om <= r0 + r || src < clo || src >= chi) continue;
      const X mv = to_x<X>(d[c * TR + r - om]);
      const X* xc = x + px.at(i0 + src);
#pragma unroll
      for (int e = 0; e < S::kC; ++e) {
        const int j = tile_column<S>(0, cg, e);
        if (j < k) tile.acc[q][e] = fma_x(mv, xc[static_cast<int64_t>(j) * px.B], tile.acc[q][e]);
      }
    }
  }
}

// Tile t - 1's mirror terms from shared memory (a block within spill_rows
// of the tile start, after its own slots): vbuf[c * Hp + j] holds row TR -
// Hp + j of tile t - 1's slot c, the window rows x[i0 + sym_shift - Hp +
// w]; s_om[c] the slot's mirror offset.  Row r takes slot c's term where
// its source row lies before the tile (om > r0 + r).
template <class S>
__device__ __forceinline__ void prev_tile_staged(WindowTile<S>& tile,
                                                 const typename S::Value* vbuf,
                                                 const unsigned char* s_win, const int* s_om,
                                                 int np, int Hp, int clo, int chi, int rr, int r0,
                                                 int sym_shift, int cg) {
  using X = typename S::Vec;
  for (int c = 0; c < np; ++c) {
    const int om = s_om[c];
    if (om <= r0 + rr) continue;  // no row of this thread's takes the slot
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int r = rr + q, src = r - om + sym_shift;
      if (om <= r0 + r || src < clo || src >= chi) continue;
      const X mv = to_x<X>(vbuf[c * Hp + Hp + r0 + r - om]);
      const X* p = reinterpret_cast<const X*>(s_win + window_row<S>(Hp + r - om) + cg * 16);
#pragma unroll
      for (int h = 0; h < S::kPieces; ++h) {
        X piece[S::kPiece];
        load_piece(p + h * S::kGroups * S::kPiece, piece);
#pragma unroll
        for (int e = 0; e < S::kPiece; ++e) {
          X& acc = tile.acc[q][h * S::kPiece + e];
          acc = fma_x(mv, piece[e], acc);
        }
      }
    }
  }
}

// pruned_spmm (kSym false) and pruned_sym_spmm (kSym true): a block owns
// rows r0 .. r0 + S::kRows of tile t (t = n_tiles: spill rows past the last
// tile) and all k columns; route is how x is staged (XRoute).
template <class S, bool kSym>
__global__ void __launch_bounds__(kBlockThreads, 2)
    pruned_spmm_kernel(const typename S::Value* __restrict__ data,
                       const typename S::Vec* __restrict__ x,
                       const int64_t* __restrict__ offsets, const int64_t* __restrict__ tile_ptr,
                       const int64_t* __restrict__ tile_end, typename S::Vec* __restrict__ y,
                       typename S::Vec* __restrict__ spill, int64_t TR, int64_t n_tiles,
                       int64_t n, int64_t m, int k, Panels px, Panels py, Panels ps,
                       int sym_shift, int spill_rows, int64_t rows_out, int route) {
  using V = typename S::Value;
  using X = typename S::Vec;
  extern __shared__ __align__(128) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  unsigned char* s_win = smem + S::kRingBytes;
  __shared__ int s_off[kOffsetChunk];
  __shared__ int s_so[kSpmmStages * kR];
  __shared__ int s_red[3 * kBlockThreads / 32];
  __shared__ long long s_prev[2];  // tile t - 1's first active slot and their count

  const int tid = threadIdx.x;
  const int64_t per_tile = TR / S::kRows;
  const int64_t t = blockIdx.x / per_tile;
  const int r0 = static_cast<int>(blockIdx.x % per_tile) * S::kRows;  // tile-local
  const int64_t i0 = t * TR + r0;                                      // global
  const int64_t s0 = t < n_tiles ? tile_ptr[t] : 0;
  const int ns = t < n_tiles ? static_cast<int>(tile_end[t] - s0) : 0;
  // tile t - 1's active slots, whose mirror terms reach rows below
  // spill_rows of this tile
  const bool has_prev = kSym && t >= 1 && t - 1 < n_tiles && r0 < spill_rows;
  const int64_t prev_p0 = has_prev ? tile_ptr[t - 1] : 0;
  const int prev_np = has_prev ? static_cast<int>(tile_end[t - 1] - prev_p0) : 0;
  if (tid == 0) s_prev[0] = prev_p0, s_prev[1] = prev_np;
  const int n_stages = (ns + kR - 1) / kR;
  // the full kernel's first ring stages fly while the offsets are reduced
  // (its stages hold the block's rows alone)
  if constexpr (!kSym) {
#pragma unroll
    for (int st = 0; st < kSpmmStages - 1; ++st) {
      if (st < n_stages)
        load_stage<S>(ring + st * S::kStageValues, s_so + st * kR, data + s0 * TR + r0,
                      offsets + s0, TR, st * kR, min(kR, ns - st * kR), S::kRows, S::kRows, 0,
                      tid);
      copy_commit();
    }
  }
  int lo, hi;
  offset_range<kBlockThreads>(offsets, s0, ns, s_red, lo, hi, prev_p0, prev_np);
  // the stage halo H (symmetric: the tile's largest mirror offset, rounded
  // up to 16) and the x window [wlo, wlo + span) relative to i0: upper
  // columns r + o and mirror sources r - om + sym_shift
  int H = 0, wlo = 0;
  int64_t span = 0;
  if (ns > 0) {
    int a = lo, b = hi;
    if constexpr (kSym) {
      const int hm = max(hi - sym_shift, 0);
      H = (hm + 15) & ~15;
      if (hm > 0) a = min(lo, sym_shift - hm), b = max(hi, sym_shift);
    }
    wlo = a;
    span = static_cast<int64_t>(b) - a + S::kRows;
  }
  const bool staged = ns > 0 && H <= S::kHaloCap && span <= S::kWindowRows;
  const int stride = S::kRows + H;           // values a slot in a stage
  const int first = max(r0 - H, 0);          // rows before the tile are not copied
  const int rows = r0 + S::kRows - first;
  const int skip = first - (r0 - H);
  const V* src = data + s0 * TR + first;
  // the window (its own cp.async group) and the symmetric kernel's first
  // ring stages
  if (staged) {
    stage_x<S>(s_win, x, i0 + wlo, static_cast<int>(span), m, k, px, route, tid);
    copy_commit();
    if constexpr (kSym) {
#pragma unroll
      for (int st = 0; st < kSpmmStages - 1; ++st) {
        if (st < n_stages)
          load_stage<S>(ring + st * S::kStageValues, s_so + st * kR, src, offsets + s0, TR,
                        st * kR, min(kR, ns - st * kR), rows, stride, skip, tid);
        copy_commit();
      }
    }
  } else {
    copy_wait<0>();  // the full kernel's ring stages, not read
  }
  const int cg = tid % S::kGroups;
  const int rr = kR * (tid / S::kGroups);  // the thread's first row in the block
  // the thread's first window row and first piece
  const unsigned char* xw = s_win + (rr / kR) * S::kGroupBytes + cg * 16;
  // column i0 + c lies in [0, m) for c in [clo, chi); rows below upper_rows
  // take upper terms
  const int clo = clamp_far(-i0);
  const int chi = clamp_far(m - i0);
  const int upper_rows = static_cast<int>(n - i0 < 0 ? 0 : n - i0 < S::kRows ? n - i0 : S::kRows);
  const bool masked = wlo < clo || wlo + span > chi ||
                      (kSym && (upper_rows < S::kRows || r0 < H));
  WindowTile<S> tile;
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int e = 0; e < S::kC; ++e) tile.acc[q][e] = tile.xr[q][e] = X(0);
  if (staged) {
    int prev = -2;  // the window row of the slot before (none before the first)
    for (int st = 0; st < n_stages; ++st) {
      // stage st landed (and at st = 0 the window: the full kernel's group
      // after its first stages); stage st - 1's buffer is free
      if (!kSym && st == 0) {
        copy_wait<0>();
      } else {
        copy_wait<kSpmmStages - 2>();
      }
      __syncthreads();
      const int nx = st + kSpmmStages - 1;
      if (nx < n_stages)
        load_stage<S>(ring + (nx % kSpmmStages) * S::kStageValues, s_so + (nx % kSpmmStages) * kR,
                      src, offsets + s0, TR, nx * kR, min(kR, ns - nx * kR), rows, stride, skip,
                      tid);
      copy_commit();
      const int buf = st % kSpmmStages;
      const int cnt = min(kR, ns - st * kR);
      if (masked) {
        spmm_stage<true, kSym, S>(tile, ring + buf * S::kStageValues, s_so + buf * kR, cnt, xw,
                                  wlo, clo, chi, rr, r0, upper_rows, sym_shift, H, stride, prev);
      } else {
        spmm_stage<false, kSym, S>(tile, ring + buf * S::kStageValues, s_so + buf * kR, cnt, xw,
                                   wlo, clo, chi, rr, r0, upper_rows, sym_shift, H, stride, prev);
      }
    }
    copy_wait<0>();
  } else {
    for (int c0 = 0; c0 < ns; c0 += kOffsetChunk) {
      const int cn = min(kOffsetChunk, ns - c0);
      __syncthreads();
      for (int c = tid; c < cn; c += kBlockThreads) s_off[c] = static_cast<int>(offsets[s0 + c0 + c]);
      __syncthreads();
      spmm_plain<kSym, S>(tile, data + (s0 + c0) * TR + r0, x, s_off, cn, TR, i0, clo, chi, rr,
                          r0, upper_rows, sym_shift, k, cg, px);
    }
  }
  // tile t - 1's mirror terms: its slots' last Hp rows and the x rows
  // [i0 + sym_shift - Hp, i0 + sym_shift) staged in the ring and the
  // window, now free, where they fit; else a gather from device memory
  // (its slots and offset range wait in shared memory, s_prev and s_red,
  // so that nothing of tile t - 1 stays in registers across the slot loop)
  int Hp = 0;
  const int64_t p0 = s_prev[0];
  const int np = static_cast<int>(s_prev[1]);
  if (kSym && np > 0) {
    int hi_prev = INT_MIN;
    for (int w = 0; w < kBlockThreads / 32; ++w)
      hi_prev = max(hi_prev, s_red[2 * (kBlockThreads / 32) + w]);
    Hp = (max(hi_prev - sym_shift, 0) + 15) & ~15;
  }
  if (Hp > 0 && np <= kOffsetChunk && Hp <= S::kWindowRows &&
      static_cast<int64_t>(np) * Hp * static_cast<int>(sizeof(V)) <= S::kRingBytes) {
    __syncthreads();  // the ring, the window and s_off are read
    constexpr int P = 16 / static_cast<int>(sizeof(V));  // values a piece
    const V* last = data + (p0 + 1) * TR - Hp;          // slot p0's last Hp rows
    for (int e = tid; e < np * (Hp / P); e += kBlockThreads) {
      const int c = e / (Hp / P), q = e - c * (Hp / P);
      copy_async<16>(ring + c * Hp + q * P, last + c * TR + q * P, true);
    }
    stage_x<S>(s_win, x, i0 + sym_shift - Hp, Hp, m, k, px, route, tid);
    copy_commit();
    for (int c = tid; c < np; c += kBlockThreads)
      s_off[c] = static_cast<int>(offsets[p0 + c]) - sym_shift;
    copy_wait<0>();
    __syncthreads();
    prev_tile_staged<S>(tile, ring, s_win, s_off, np, Hp, clo, chi, rr, r0, sym_shift, cg);
  } else if (Hp > 0) {
    for (int c0 = 0; c0 < np; c0 += kOffsetChunk) {
      const int cn = min(kOffsetChunk, np - c0);
      __syncthreads();
      for (int c = tid; c < cn; c += kBlockThreads)
        s_off[c] = static_cast<int>(offsets[p0 + c0 + c]) - sym_shift;
      __syncthreads();
      spmm_prev_tile<S>(tile, data + (p0 + c0) * TR + TR + r0, x, s_off, cn, TR, i0, clo, chi,
                        rr, r0, sym_shift, k, cg, px);
    }
  }
  const int64_t i = i0 + rr;
  store_tile<S>(tile, y, i, n, n, k, 0, cg, py);
  if (kSym && i + kR > n && i < rows_out) {  // rows n .. rows_out: the spill
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int64_t r = i + q;
      if (r < n || r >= rows_out) continue;
#pragma unroll
      for (int e = 0; e < S::kC; ++e) {
        const int j = tile_column<S>(0, cg, e);
        if (j < k) spill[ps.at(r - n) + static_cast<int64_t>(j) * ps.B] = tile.acc[q][e];
      }
    }
  }
}

template <typename V, typename X, int G, bool kSym>
cudaError_t launch_spmm_g(const void* data, const void* x, const void* offsets,
                          const void* tile_ptr, const void* tile_end, void* y, void* spill,
                          int64_t TR, int64_t n_tiles, int64_t n, int64_t m, int k, Panels px,
                          Panels py, Panels ps, int sym_shift, int spill_rows, int64_t rows_out,
                          int device, cudaStream_t stream) {
  using S = SpmmShape<V, X, G, kSym>;
  const int64_t blocks = (rows_out + S::kRows - 1) / S::kRows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  auto kernel = pruned_spmm_kernel<S, kSym>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kernel, S::kSmemBytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, S::kSmemBytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(tile_ptr),
      static_cast<const int64_t*>(tile_end), static_cast<X*>(y), static_cast<X*>(spill), TR,
      n_tiles, n, m, k, px, py, ps, sym_shift, spill_rows, rows_out,
      px.B == 1 ? pick_route<S>(x, k, px) : kPanelValues);
  return cudaGetLastError();
}

// The device's SM count, read once per device.
int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return counts[device];
}

// G: the fewest column groups whose tiles cover k (C columns a thread), at
// least 2 with 8-byte values (a 1024-row ring stage of them would leave the
// window too little shared memory); doubled where the grid would fill at
// most half the SMs, so that a small operand's rows, x window and y spread
// over twice the blocks (the threads past k compute zeros; each row's sum
// is the same, in the same order).
template <typename V, typename X, bool kSym>
cudaError_t launch_spmm(const void* data, const void* x, const void* offsets,
                        const void* tile_ptr, const void* tile_end, void* y, void* spill,
                        int64_t TR, int64_t n_tiles, int64_t n, int64_t m, int k, Panels px,
                        Panels py, Panels ps, int sym_shift, int spill_rows, int64_t rows_out,
                        int device, cudaStream_t s) {
  constexpr int C = sizeof(X) == 8 ? 4 : 8;
  constexpr int kMaxG = sizeof(X) == 8 ? 4 : 2;
  int G = sizeof(V) == 8 ? 2 : 1;
  while (G * C < k) G *= 2;
  const int64_t blocks = (rows_out + kR * kBlockThreads / G - 1) / (kR * kBlockThreads / G);
  if (G < kMaxG && 2 * blocks <= sm_count(device)) G *= 2;
#define SPMM_G(GG)                                                                              \
  launch_spmm_g<V, X, GG, kSym>(data, x, offsets, tile_ptr, tile_end, y, spill, TR, n_tiles, n, \
                                m, k, px, py, ps, sym_shift, spill_rows, rows_out, device, s)
  if constexpr (sizeof(V) < 8) {
    if (G == 1) return SPMM_G(1);
  }
  if (G == 2) return SPMM_G(2);
  if constexpr (sizeof(X) == 8) {
    if (G == 4) return SPMM_G(4);
  }
#undef SPMM_G
  return cudaErrorInvalidValue;
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

// Checks shared by the entry points; false for what the kernels do not take.
bool valid(int64_t TR, int64_t G, int64_t n, int64_t k) {
  return TR > 0 && TR % kRows == 0 && TR < kFar && G >= 1 && n <= G * TR && k >= 1 &&
         k <= 16;
}

// the TMA bulk copies read the value stripes from a 16-byte boundary
bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int sigma_pruned_spmv(int device, int vtype, int xtype,
                                 const void* data, const void* x,
                                 const void* offsets, const void* tile_ptr,
                                 const void* tile_end, void* y, int64_t TR, int64_t G,
                                 int64_t n, int64_t m, void* stream) {
  if (!valid(TR, G, n, 1) || !aligned(data)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PRUNED_DISPATCH(vtype, xtype, (launch_spmv<V, X>(data, x, offsets, tile_ptr, tile_end, y,
                                                   TR, n, m, device, s)));
}

extern "C" int sigma_pruned_spmm(int device, int vtype, int xtype,
                                 const void* data, const void* x,
                                 const void* offsets, const void* tile_ptr,
                                 const void* tile_end, void* y, int64_t TR, int64_t G,
                                 int64_t n, int64_t m, int64_t k, int64_t bx, int64_t by,
                                 void* stream) {
  Panels px, py;
  if (!valid(TR, G, n, k) || !aligned(data) || !make_panels(bx, k, m, &px) ||
      !make_panels(by, k, n, &py))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PRUNED_DISPATCH(vtype, xtype, (launch_spmm<V, X, false>(
      data, x, offsets, tile_ptr, tile_end, y, nullptr, TR, G, n, m, static_cast<int>(k), px, py,
      py, 0, 0, n, device, s)));
}

extern "C" int sigma_pruned_sym_spmv(int device, int vtype, int xtype,
                                     const void* data, const void* x,
                                     const void* offsets, const void* tile_ptr,
                                     const void* tile_end, void* y, void* spill, int64_t TR,
                                     int64_t G, int64_t n, int64_t m, int64_t sym_shift,
                                     int64_t spill_rows, int64_t rows_out, void* stream) {
  if (!valid(TR, G, n, 1) || !aligned(data) || spill_rows > TR || rows_out < n ||
      rows_out > n + spill_rows || (rows_out > n && spill == nullptr) || sym_shift < 0 ||
      sym_shift >= kFar)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PRUNED_DISPATCH(vtype, xtype, (launch_sym_spmv<V, X>(
      data, x, offsets, tile_ptr, tile_end, y, spill, TR, G, n, m, static_cast<int>(sym_shift),
      static_cast<int>(spill_rows), rows_out, device, s)));
}

extern "C" int sigma_pruned_sym_spmm(int device, int vtype, int xtype,
                                     const void* data, const void* x,
                                     const void* offsets, const void* tile_ptr,
                                     const void* tile_end, void* y, void* spill, int64_t TR,
                                     int64_t G, int64_t n, int64_t m, int64_t k, int64_t bx,
                                     int64_t by, int64_t bs, int64_t sym_shift,
                                     int64_t spill_rows, int64_t rows_out, void* stream) {
  Panels px, py, ps;
  if (!valid(TR, G, n, k) || !aligned(data) || spill_rows > TR || rows_out < n ||
      rows_out > n + spill_rows || (rows_out > n && spill == nullptr) || sym_shift < 0 ||
      sym_shift >= kFar || !make_panels(bx, k, m, &px) || !make_panels(by, k, n, &py) ||
      !make_panels(bs, k, spill_rows, &ps))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PRUNED_DISPATCH(vtype, xtype, (launch_spmm<V, X, true>(
      data, x, offsets, tile_ptr, tile_end, y, spill, TR, G, n, m, static_cast<int>(k), px, py,
      ps, static_cast<int>(sym_shift), static_cast<int>(spill_rows), rows_out, device, s)));
}
