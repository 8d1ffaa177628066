// The level-scheduled triangular sweep of ILDU / ILU(k), one launch a
// sweep, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port's counterpart of the
// ``lax.fori_loop`` over dependency levels in
// ``sigma_tpu/solvers/ildu.py`` ``TriangularLevels.solve`` and of the same
// loop inside ``shard_map`` in ``sigma_tpu/parallel/precond.py``
// (``DistributedBlockILDU.matvec``'s ``sweep``), which XLA runs on the
// device inside the compiled Krylov loop.  It solves (I + T) x = b for a
// strict triangular T packed by level: for l = 0 .. nlev - 1 and each slot
// i of [level_ptr[l], level_ptr[l + 1]),
//
//     x[rows[i]] = b[rows[i]] - sum_j vals[i, j] * x[cols[i, j]],
//
// the terms added in slot order j = 0 .. width - 1 in the vector's dtype
// (the promoted dtype of every pair taken), each operation correctly
// rounded (no contraction into an FMA).  A row's unused slots point at
// the row itself with value 0; they are skipped, so x needs no zeroing
// (the plain version adds their 0 * 0).
//
// Design: no barrier between levels; each row waits on its own
// dependencies alone.  Every row has a ready flag, a word of x's width
// (int32 for f32 x, int64 for f64), zero on entry: the wrapper allocates
// them beside x on each call, so the sweep keeps no state and replays
// from a CUDA graph.  Once a row's x is computed, it is written to x and
// its flag is set to the complement of x's bits (a NaN made canonical
// first, so no value leaves the flag zero), with a relaxed store at device
// scope.  A poll that sees a flag nonzero so holds the value itself: a
// level of the dependency chain costs one store reaching L2 and one poll
// returning it, where a release store (a fence that waits for x's store
// to be acknowledged), an acquire fence and a second trip for x would
// each add an L2 round trip (tools/compare_level_sweep.py measured that
// form slower than the grid barrier it replaced: PERF.md section 6).
//
// A persistent grid walks the packed slots in increasing order, slot i to
// thread i mod (the grid's threads), each thread in increasing i.  A
// thread loads what does not depend on the sweep before it waits: its
// row, the row's cols and vals (up to W slots in registers, W the
// smallest of 4, 8 and 16 that holds the width; a wider row takes its
// later chunks of 16 after the first chunk's wait) and b; and while it
// waits on one slot, the row and entries of its next slot are already on
// their way.  A wait polls the flags of its real slots with relaxed loads,
// all in flight together: kSpinPolls polls back to back, then a back-off
// of __nanosleep from 32 to 256 ns between polls.  x's terms are then
// added in slot order from the values the polls returned.
//
// Progress: a real slot's column is a row of a lower level, which the
// packing puts at a lower position, so the lowest unfinished slot can
// always proceed, and its thread has finished every earlier slot of its
// own.  The launch is cooperative (``cudaLaunchAttributeCooperative``
// through ``cudaLaunchKernelEx``) only for the runtime's guarantee that
// every block is resident.  Lanes of one warp wait on each other where
// the warp's 32 slots straddle a level boundary; independent thread
// scheduling (sm_70 on) lets the producing lane go on while its
// neighbour spins.  A wait that lasts kStallPolls polls (only a packing
// that breaks the order, which the port never builds, could cause one)
// traps, so such a launch fails instead of hanging the card.
//
// The grid is the smaller of the co-resident maximum (occupancy x SMs)
// and kLevelsAhead = 4 times the blocks the widest level needs: a
// thread's slots lie a few levels apart, so its next slot's loads are done
// before that slot's level begins, while few enough threads poll that the
// polls do not crowd the chain's own traffic in L2.  On the 7-point
// stencil's ILDU(0), ILU(1) and block ILDU factors, 2 and 4 times ran
// faster than 1 and 8 times and far faster than the co-resident grid; the
// colour-ordered sweep ran alike on all (PERF.md section 6:
// tools/compare_level_sweep.py times the grids, chip_smoke.py's
// level_sweep_checks this one against the co-resident one).
//
// Bound: the bytes (rows, the real entries' cols and vals, b, x read once
// and written once).  In practice a deep sweep is held by its chain of
// dependent levels (the 7-point stencil at nx = 100 has 298 levels a
// sweep in natural order), each a store and a poll through L2, a shallow
// one (its colour-ordered ILDU(0): 2 levels) by its bytes.
//
// Layout: rows (n,) int64 level by level; cols (n, width) int64 and vals
// (n, width) row-major; level_ptr (nlev + 1,) int64 on the device (the
// kernel reads its first and last entries: the slots it walks); b and x
// (n,) contiguous; flag (n,) zeros of x's width.  dtype codes 0 float32, 1
// float64 (the DIA kernels'); the pairs (values, vector) taken: (0, 0),
// (1, 1), (0, 1).
//
// Every entry returns a cudaError_t (0 on success) and synchronises
// nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// the grid: this many times the blocks of the widest level
constexpr int64_t kLevelsAhead = 4;
// a wait polls kSpinPolls times back to back, then sleeps between polls
// from kSleepMinNs, doubling kSleepDoublings times (to 256 ns)
constexpr unsigned kSpinPolls = 4;
constexpr unsigned kSleepMinNs = 32;
constexpr unsigned kSleepDoublings = 3;
// a wait of this many polls traps: each poll waits for its load from L2,
// so this is seconds, and only a packing that breaks the order waits so
// long
constexpr unsigned kStallPolls = 1u << 24;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

// A row's ready flag: zero until the row's x is written, then the
// complement of x's bits (NaNs made canonical first, so no value gives
// all ones and so a zero flag).  Stored and read relaxed at device scope,
// one aligned word, so a poll that sees it nonzero holds the value.
template <typename X>
struct Flag;

template <>
struct Flag<float> {
  using Word = unsigned;
  static __device__ Word peek(const Word* p) {
    Word v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
  }
  static __device__ void publish(Word* p, float x) {
    const Word w = ~(x == x ? __float_as_uint(x) : 0x7FFFFFFFu);
    asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(w) : "memory");
  }
  static __device__ float value(Word w) { return __uint_as_float(~w); }
};

template <>
struct Flag<double> {
  using Word = unsigned long long;
  static __device__ Word peek(const Word* p) {
    Word v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
  }
  static __device__ void publish(Word* p, double x) {
    const Word w =
        ~(x == x ? static_cast<Word>(__double_as_longlong(x)) : 0x7FF8000000000000ull);
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
  }
  static __device__ double value(Word w) {
    return __longlong_as_double(static_cast<long long>(~w));
  }
};

// Loads of the sweep's read-only inputs.  Volatile, so that they stay
// where the code places them, before the polls of an earlier slot's wait;
// nothing waits for them until their values are used.
__device__ __forceinline__ int64_t load(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float load(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ double load(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// Poll until the flag of every column c[k] with bit k of `pending` set is
// published, each into w[k] (left as it is for the other k).  The first
// kSpinPolls polls follow each other at once; then the back-off.
template <typename X, int W>
__device__ __forceinline__ void wait_flags(const typename Flag<X>::Word* flag,
                                           const int64_t (&c)[W], unsigned pending,
                                           typename Flag<X>::Word (&w)[W]) {
  for (unsigned polls = 1;; ++polls) {
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (pending >> k & 1u) w[k] = Flag<X>::peek(flag + c[k]);
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (w[k] != 0) pending &= ~(1u << k);
    if (pending == 0) return;
    if (polls < kSpinPolls) continue;
    if (polls > kStallPolls) __trap();
    const unsigned doublings = polls - kSpinPolls;
    __nanosleep(kSleepMinNs << (doublings < kSleepDoublings ? doublings : kSleepDoublings));
  }
}

// One slot's row and its first W entries, loaded before anything waits
// on them.
template <typename V, int W>
struct Slot {
  int64_t r;
  int64_t c[W];
  V v[W];
};

template <typename V, int W>
__device__ __forceinline__ void load_slot(Slot<V, W>& s, const int64_t* __restrict__ rows,
                                          const int64_t* __restrict__ cols,
                                          const V* __restrict__ vals, int64_t i, int64_t j0,
                                          int64_t width) {
  const int64_t* ci = cols + i * width + j0;
  const V* vi = vals + i * width + j0;
  s.r = load(rows + i);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const bool in = j0 + k < width;
    s.c[k] = in ? load(ci + k) : -1;
    s.v[k] = in ? load(vi + k) : V(0);
  }
}

// acc plus the slot's real terms (a real slot's column is not its own
// row; -1 marks a slot past the width), in slot order, once their rows'
// flags are published.
template <typename V, typename X, int W>
__device__ __forceinline__ X add_terms(X acc, const Slot<V, W>& s,
                                       const typename Flag<X>::Word* flag) {
  using O = Rn<X>;
  unsigned real = 0;  // bit k: slot k is used
#pragma unroll
  for (int k = 0; k < W; ++k) real |= unsigned(s.c[k] != s.r && s.c[k] >= 0) << k;
  typename Flag<X>::Word w[W] = {};
  if (real) wait_flags<X, W>(flag, s.c, real, w);
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (real >> k & 1u)
      acc = O::add(acc, O::mul(static_cast<X>(s.v[k]), Flag<X>::value(w[k])));
  return acc;
}

// A thread's slots are i, i + stride, ...; while it waits on one, the
// next one's row and entries are already on their way.  A row wider than
// W slots takes its later chunks after the first chunk's wait.
template <typename V, typename X, int W>
__global__ void __launch_bounds__(kThreads)
    level_sweep_kernel(const int64_t* __restrict__ rows, const int64_t* __restrict__ cols,
                       const V* __restrict__ vals, const int64_t* __restrict__ level_ptr,
                       const X* __restrict__ b, X* __restrict__ x,
                       typename Flag<X>::Word* flag, int64_t nlev, int64_t width) {
  using O = Rn<X>;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t hi = level_ptr[nlev];
  int64_t i = level_ptr[0] + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= hi) return;
  Slot<V, W> cur, next;
  load_slot(cur, rows, cols, vals, i, 0, width);
  for (;;) {
    const X bi = load(b + cur.r);
    const int64_t after = i + stride;
    if (after < hi) load_slot(next, rows, cols, vals, after, 0, width);
    X acc = add_terms(X(0), cur, flag);
    for (int64_t j0 = W; j0 < width; j0 += W) {
      Slot<V, W> more;
      load_slot(more, rows, cols, vals, i, j0, width);
      acc = add_terms(acc, more, flag);
    }
    const X xr = O::sub(bi, acc);
    x[cur.r] = xr;
    Flag<X>::publish(flag + cur.r, xr);
    if (after >= hi) break;
    cur = next;
    i = after;
  }
}

// The blocks of a sweep whose widest level holds `max_rows` rows: at most
// the kernel's co-resident maximum, at least 1.
template <typename V, typename X, int W>
cudaError_t grid_blocks(int64_t max_rows, int64_t* blocks) {
  static int per_device[kMaxDevices] = {};  // co-resident blocks, 0 until asked
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_device[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_sweep_kernel<V, X, W>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    per_device[device] = per_sm * sms;
  }
  const int64_t most = per_device[device];
  const int64_t rows = max_rows < most * kThreads ? max_rows : most * kThreads;
  const int64_t want = (kLevelsAhead * rows + kThreads - 1) / kThreads;
  *blocks = want < 1 ? 1 : (want < most ? want : most);
  return cudaSuccess;
}

template <typename V, typename X, int W>
cudaError_t launch(const void* rows, const void* cols, const void* vals, const void* level_ptr,
                   const void* b, void* x, void* flag, int64_t nlev, int64_t width,
                   int64_t max_rows, cudaStream_t stream) {
  int64_t blocks = 0;
  cudaError_t err = grid_blocks<V, X, W>(max_rows, &blocks);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, level_sweep_kernel<V, X, W>, static_cast<const int64_t*>(rows),
                           static_cast<const int64_t*>(cols), static_cast<const V*>(vals),
                           static_cast<const int64_t*>(level_ptr), static_cast<const X*>(b),
                           static_cast<X*>(x), static_cast<typename Flag<X>::Word*>(flag),
                           nlev, width);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel's register chunk for a row of `width` slots.
template <typename V, typename X>
cudaError_t launch_width(const void* rows, const void* cols, const void* vals,
                         const void* level_ptr, const void* b, void* x, void* flag,
                         int64_t nlev, int64_t width, int64_t max_rows, cudaStream_t stream) {
  if (width <= 4)
    return launch<V, X, 4>(rows, cols, vals, level_ptr, b, x, flag, nlev, width, max_rows,
                           stream);
  if (width <= 8)
    return launch<V, X, 8>(rows, cols, vals, level_ptr, b, x, flag, nlev, width, max_rows,
                           stream);
  return launch<V, X, 16>(rows, cols, vals, level_ptr, b, x, flag, nlev, width, max_rows,
                          stream);
}

template <typename V, typename X>
cudaError_t blocks_width(int64_t width, int64_t max_rows, int64_t* blocks) {
  if (width <= 4) return grid_blocks<V, X, 4>(max_rows, blocks);
  if (width <= 8) return grid_blocks<V, X, 8>(max_rows, blocks);
  return grid_blocks<V, X, 16>(max_rows, blocks);
}

cudaError_t set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x solving (I + T) x = b over `nlev` levels; `flag` (n,) int32 zeros;
// `max_rows` the rows of the widest level (it sizes the grid).
extern "C" int sigma_level_sweep(int device, int vtype, int xtype, const void* rows,
                                 const void* cols, const void* vals, const void* level_ptr,
                                 const void* b, void* x, void* flag, int64_t nlev, int64_t width,
                                 int64_t max_rows, void* stream) {
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (vtype == 0 && xtype == 0)
    return launch_width<float, float>(rows, cols, vals, level_ptr, b, x, flag, nlev, width,
                                      max_rows, st);
  if (vtype == 1 && xtype == 1)
    return launch_width<double, double>(rows, cols, vals, level_ptr, b, x, flag, nlev, width,
                                        max_rows, st);
  if (vtype == 0 && xtype == 1)
    return launch_width<float, double>(rows, cols, vals, level_ptr, b, x, flag, nlev, width,
                                       max_rows, st);
  return cudaErrorInvalidValue;
}

// The blocks sigma_level_sweep launches for these dtypes, `width` and
// `max_rows`, into *blocks.
extern "C" int sigma_level_sweep_blocks(int device, int vtype, int xtype, int64_t width,
                                        int64_t max_rows, int64_t* blocks) {
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return err;
  if (vtype == 0 && xtype == 0) return blocks_width<float, float>(width, max_rows, blocks);
  if (vtype == 1 && xtype == 1) return blocks_width<double, double>(width, max_rows, blocks);
  if (vtype == 0 && xtype == 1) return blocks_width<float, double>(width, max_rows, blocks);
  return cudaErrorInvalidValue;
}
