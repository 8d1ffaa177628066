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
// The SpMM kernels (pruned_spmm, pruned_sym_spmm).  One thread per output
// row, as the DIA kernels (dia_spmv.cu): the block stages its tile's slot
// offsets in shared memory (in chunks) and every thread walks the same
// list, so there is no divergence, and neighbouring threads read
// neighbouring values of each slot stripe and neighbouring x[i + o]: both
// streams coalesce.  Each value, loaded once, is multiplied into K in
// {4, 8, 16} register accumulators (runtime k <= K, touched only in
// unrolled loops under j < k).  The slot loop is not unrolled: measured
// with ptxas -v on sm_90a, unrolling it 2 to 16 times spills 40-284 bytes
// over the instantiations, not unrolling it spills none.  Panels are
// addressed with the panel-block length B of dia_spmm.cu (B = length:
// RHS-major (k, len); B = 1: columns (len, k)).  They walk the padding
// slots too, and the symmetric one reads each value twice (upper term at
// row i, mirror term at row i + om, the second read from L2).
//
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
// term, then tile t - 1's mirror terms.  Skipping the padding removes only
// + 0 * x terms.  Out-of-range terms (column outside [0, m)) are skipped,
// never multiplied by zero.  Accumulation is in the vector type X; the five
// (value, vector) dtype pairs of the DIA kernels.
//
// Interface.  Plain C entry points bound with ctypes; each launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k, a
// panel-block length, a tile height or a data pointer it does not take.

#include <climits>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
  int a = INT_MAX, b = INT_MIN;
  for (int c = threadIdx.x; c < ns; c += kBlock) {
    const int o = static_cast<int>(offsets[s0 + c]);
    a = min(a, o);
    b = max(b, o);
  }
  a = __reduce_min_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  constexpr int W = kBlock / 32;
  if ((threadIdx.x & 31) == 0) {
    s_red[threadIdx.x >> 5] = a;
    s_red[W + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
  for (int w = 0; w < W; ++w) {
    lo = min(lo, s_red[w]);
    hi = max(hi, s_red[W + w]);
  }
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
  __shared__ int s_red[2 * kBlock / 32];
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
  __shared__ int s_red[2 * kBlock / 32];
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
