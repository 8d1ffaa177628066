// DIA sparse matrix times k dense panels for any k, each stored value read
// from device memory once for all k, for Hopper (sm_90a).
//
//   dia_spmm_grouped  replaces sigma_tpu/ops/spmv_pallas.py dia_spmm_grouped
//                     and dia_spmm_grouped_chunked: Y = A X from
//                     full-storage DIA, rectangular n x m, for k > 16
//                     right-hand sides on wide bands (DIAMatrix.matmat's
//                     grouped route; LOBPCG's [X, W, P] basis is k = 3m).
//
// What bounds it.  Memory: on a wide band the values dominate (245
// diagonals of an RCM-ordered mesh against 2k panel values per row), and
// the 16-column passes of dia_spmm read every value ceil(k/16) times.  The
// byte floor is the values once plus k x-panels read and k y-panels
// written: 9.89 + 1.29 + 1.29 GB for the 10.1M-row band at k = 32 in f32.
// The TPU kernel got the single value stream by revisiting each data tile
// across an outer grid axis over groups of panels, and read x from VMEM
// windows.  Its arithmetic is 2k flops per stored value (2.4 ms of f32 FMA
// for that product), so on this card the x operand of each FMA, not the
// value stream, is what a kernel has to feed.
//
// Design.  A block owns 256 consecutive rows, two adjacent rows a thread.
// It walks the diagonals in slabs.  Per slab it copies its rows' values of
// the slab from device memory into shared memory (asynchronous 16-byte
// copies, coalesced, once).  The slab's diagonals fall into runs whose
// joint x window -- rows [i0 + min offset, i0 + 255 + max offset] -- fits
// the window space: a band's slab of consecutive offsets is one run, a 3-D
// stencil's offsets +-n^2 apart are one run each.  For each group of up to
// 32 columns (16 for f64 vectors) and each run, the block copies the
// run's x window of the group's panels into shared memory (asynchronous
// copies, zeros outside [0, m)) and applies the run's diagonals from
// there, accumulating in registers.  For k <= 32 there is one group and
// its accumulators live across all slabs; for more columns each group's
// partial sums go to y between slabs (read back by the same thread), so
// the values are still read from device memory once.
//
// Two rows a thread is for the band: at consecutive offsets o and o + 1,
// row i's x value x[i + o + 1] is row i + 1's at the diagonal before, so
// the thread carries it in a register and reads one window value per
// column for two FMAs.  The kernel is bound by those shared-memory reads
// and by the staging copies, not by device memory (PERF.md).  Its first
// version read x from global memory: 32 L1 misses per stored value, 21x
// its bound on the 10.1M-row band at k = 32.  Then came the x windows,
// the two rows a thread, and asynchronous staging copies (a
// load-then-store loop exposed one memory latency per diagonal).  The
// window copies, re-staged per slab as 4-byte copies, are what is left to
// cut: staging a band's whole window once per block is the next step.
//
// Shared memory: 72 KB a block (3 blocks an SM, as the 165 registers a
// thread also allow): a slab's values (35 diagonals for f32 values and f32
// x) and offsets, its runs, and the window of one run and group.  The
// window's row stride is odd, so the transposing copy of (m, k) column
// panels and the reads of the compute loop are free of bank conflicts.
//
// Panels: the Panels block-length addressing of dia_spmm.cu, B = m (or n)
// for RHS-major (k, m) panels and B = 1 for (m, k) columns.  The TPU
// kernel's grouped-interleaved layout existed to cut panels into DMA
// chunks and is not used.  Masking, types and 64-bit indexing as in
// dia_spmm.cu: out-of-range terms are skipped, accumulation is in the
// vector type, the five (value, vector) dtype pairs.
//
// Interface.  One plain C entry point bound with ctypes; it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k or a
// panel-block length it does not take.

#include "dia_common.cuh"

namespace {

using namespace sigma_dia;

constexpr int kThreads2 = 128;                // threads per block
constexpr int kRowsPerBlock = 2 * kThreads2;  // two adjacent rows a thread
constexpr int kSmemBytes = 72 * 1024;         // dynamic shared memory per block (3 an SM)

// columns per group: the accumulators of a thread's two rows and the x
// values carried between diagonals stay in registers (96 of them)
template <typename X>
constexpr int kGroupCols = sizeof(X) == 8 ? 16 : 32;

// The values of a thread's two rows at one diagonal, read as one access.
template <typename V>
struct alignas(2 * sizeof(V)) Pair {
  V a, b;
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

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory layout of a block: a slab's values (slab x 256 rows) and
// offsets, its runs (diagonals whose x windows share one staging), then
// the x window of one run and one group of columns.
template <typename V, typename X>
struct Layout {
  int slab, stride;  // diagonals a slab; the window's row stride (odd)
  Layout() {
    const int row_bytes = kGroupCols<X> * static_cast<int>(sizeof(X));
    for (slab = 256; slab > 1; --slab) {
      if (head_bytes(slab) + (kRowsPerBlock + slab) * row_bytes <= kSmemBytes) break;
    }
    stride = (kSmemBytes - head_bytes(slab)) / row_bytes;
    if (stride % 2 == 0) --stride;
  }
  // values, offsets and run lows (int64), run starts (slab + 1) and spans (int)
  __host__ __device__ static int head_bytes(int s) {
    const int b = s * kRowsPerBlock * static_cast<int>(sizeof(V)) + s * 16 + (2 * s + 1) * 4;
    return (b + 15) / 16 * 16;
  }
};

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads2)
    dia_spmm_grouped_kernel(const V* __restrict__ data, const X* __restrict__ x,
                            const int64_t* __restrict__ offsets, X* __restrict__ y,
                            int64_t D, int64_t stride, int64_t n, int64_t m, int k,
                            Panels px, Panels py, int slab, int wstride) {
  constexpr int G = kGroupCols<X>;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(V));    // values a 16-byte copy
  constexpr int kChunks = kRowsPerBlock / kPerChunk;              // copies a diagonal
  extern __shared__ __align__(16) unsigned char smem[];
  V* s_val = reinterpret_cast<V*>(smem);
  int64_t* s_off = reinterpret_cast<int64_t*>(s_val + slab * kRowsPerBlock);
  int64_t* s_rlo = s_off + slab;
  int* s_run = reinterpret_cast<int*>(s_rlo + slab);
  int* s_rspan = s_run + slab + 1;
  X* s_x = reinterpret_cast<X*>(smem + Layout<V, X>::head_bytes(slab));
  __shared__ int s_nruns;
  const int tid = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t ia = i0 + 2 * tid;  // this thread's rows: ia and ia + 1
  const bool has_a = ia < n, has_b = ia + 1 < n;
  const int groups = (k + G - 1) / G;
  const Pair<V>* pairs = reinterpret_cast<const Pair<V>*>(s_val);
  X acc_a[G], acc_b[G], carry[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc_a[j] = acc_b[j] = X(0);
  for (int64_t d0 = 0; d0 < D; d0 += slab) {
    const int dn = static_cast<int>(D - d0 < slab ? D - d0 : slab);
    __syncthreads();  // the previous slab is consumed
    for (int t = tid; t < dn; t += kThreads2) s_off[t] = offsets[d0 + t];
    // the slab's values, 16 bytes a copy; a row past the stored stride
    // (the last block) reads as zero
    for (int c = tid; c < dn * kChunks; c += kThreads2) {
      const int t = c / kChunks, q = c % kChunks;
      const int64_t row = i0 + static_cast<int64_t>(q) * kPerChunk;
      const bool valid = row < stride;
      copy_async<16>(s_val + t * kRowsPerBlock + q * kPerChunk,
                     valid ? data + (d0 + t) * stride + row : data, valid);
    }
    copy_async_wait();
    __syncthreads();
    if (tid == 0) {
      // runs of diagonals whose joint x window fits the window space
      int nr = 0;
      int64_t lo = 0, hi = 0;
      for (int t = 0; t < dn; ++t) {
        const int64_t o = s_off[t];
        const int64_t nlo = t == 0 || o < lo ? o : lo, nhi = t == 0 || o > hi ? o : hi;
        if (t > 0 && nhi - nlo + kRowsPerBlock <= wstride) {
          lo = nlo;
          hi = nhi;
        } else {
          if (t > 0) {
            s_rlo[nr] = lo;
            s_rspan[nr] = static_cast<int>(hi - lo) + kRowsPerBlock;
            ++nr;
          }
          s_run[nr] = t;
          lo = hi = o;
        }
      }
      s_rlo[nr] = lo;
      s_rspan[nr] = static_cast<int>(hi - lo) + kRowsPerBlock;
      s_run[nr + 1] = dn;
      s_nruns = nr + 1;
    }
    __syncthreads();
    const int nruns = s_nruns;
    for (int g = 0; g < groups; ++g) {
      const int j0 = g * G;
      X* ya = y + py.at(ia) + static_cast<int64_t>(j0) * py.B;
      X* yb = y + py.at(ia + 1) + static_cast<int64_t>(j0) * py.B;
      if (groups > 1 && has_a) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const bool fresh = d0 == 0 || j0 + j >= k;
          acc_a[j] = fresh ? X(0) : ya[j * py.B];
          acc_b[j] = (fresh || !has_b) ? X(0) : yb[j * py.B];
        }
      }
      for (int r = 0; r < nruns; ++r) {
        // the run's x window: rows w0 .. w0 + span - 1 of the group's panels
        const int64_t w0 = i0 + s_rlo[r];
        const int span = s_rspan[r];
        if (r > 0 || g > 0) __syncthreads();  // the previous window is consumed
        if (px.B == 1) {
          // (m, k) columns: consecutive threads take a row's consecutive columns
          for (int e = tid; e < G * span; e += kThreads2) {
            const int jj = e % G, rr = e / G;
            const int64_t c = w0 + rr;
            const bool valid = c >= 0 && c < m && j0 + jj < k;
            copy_async<static_cast<int>(sizeof(X))>(s_x + jj * wstride + rr,
                                  valid ? x + px.at(c) + j0 + jj : x, valid);
          }
        } else {
          for (int jj = 0; jj < G; ++jj) {
            const bool col = j0 + jj < k;
            const X* xj = x + static_cast<int64_t>(j0 + jj) * px.B;
            for (int rr = tid; rr < span; rr += kThreads2) {
              const int64_t c = w0 + rr;
              const bool valid = col && c >= 0 && c < m;
              copy_async<static_cast<int>(sizeof(X))>(s_x + jj * wstride + rr, valid ? xj + px.at(c) : x, valid);
            }
          }
        }
        copy_async_wait();
        __syncthreads();
        if (!has_a) continue;
        // an out-of-range term's value is selected away, never multiplied
        // by zero: the window holds zeros there and the value may not be 0
        int64_t prev = 0;
        for (int t = s_run[r]; t < s_run[r + 1]; ++t) {
          const int64_t o = s_off[t];
          const int64_t ca = ia + o;
          const Pair<V> vv = pairs[t * kThreads2 + tid];
          const X va = (ca >= 0 && ca < m) ? to_x<X>(vv.a) : X(0);
          const X vb = (ca + 1 >= 0 && ca + 1 < m) ? to_x<X>(vv.b) : X(0);
          const X* xs = s_x + (ca - w0);
          if (t > s_run[r] && o == prev + 1) {
            // row a's x is row b's x at the previous diagonal
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const X xb = xs[j * wstride + 1];
              acc_a[j] += va * carry[j];
              acc_b[j] += vb * xb;
              carry[j] = xb;
            }
          } else {
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const X xb = xs[j * wstride + 1];
              acc_a[j] += va * xs[j * wstride];
              acc_b[j] += vb * xb;
              carry[j] = xb;
            }
          }
          prev = o;
        }
      }
      if (groups > 1 && has_a) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j0 + j < k) {
            ya[j * py.B] = acc_a[j];
            if (has_b) yb[j * py.B] = acc_b[j];
          }
        }
      }
    }
  }
  if (has_a && groups == 1) {
    X* ya = y + py.at(ia);
    X* yb = y + py.at(ia + 1);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < k) {
        ya[j * py.B] = acc_a[j];
        if (has_b) yb[j * py.B] = acc_b[j];
      }
    }
  }
  if (groups > 1 && D == 0) {  // no diagonals: y is never written above
    for (int64_t r = ia; r < ia + 2 && r < n; ++r)
      for (int j = 0; j < k; ++j) y[py.at(r) + static_cast<int64_t>(j) * py.B] = X(0);
  }
}

template <typename V, typename X>
cudaError_t launch(const void* data, const void* x, const void* offsets, void* y,
                   int64_t D, int64_t stride, int64_t n, int64_t m, int k, Panels px,
                   Panels py, cudaStream_t stream) {
  // 16-byte value copies: aligned rows, whole copies within a row
  if (reinterpret_cast<uintptr_t>(data) % 16 || stride % (16 / sizeof(V)))
    return cudaErrorInvalidValue;
  static const Layout<V, X> layout;
  auto kernel = dia_spmm_grouped_kernel<V, X>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kThreads2, kSmemBytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m, k, px, py,
      layout.slab, layout.stride);
  return cudaGetLastError();
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
