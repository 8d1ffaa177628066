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
// Design: one persistent grid of co-resident blocks walks the levels in
// order; a level's rows are spread over all its threads, one row a thread,
// and a grid-wide barrier (cooperative_groups' ``this_grid().sync()``)
// separates two levels.  The launch is cooperative
// (``cudaLaunchAttributeCooperative`` through ``cudaLaunchKernelEx``), so
// the CUDA runtime checks that every block is resident rather than the
// kernel assuming it; it is captured into a CUDA graph like any launch.  x is
// written by other SMs between levels and L1 is not coherent across SMs,
// so x's gathers bypass L1 (``__ldcg``); the barrier's fence makes the
// writes of one level visible in L2 to the next.
//
// The grid is the smaller of the co-resident maximum (occupancy x SMs)
// and the blocks the widest level needs: a barrier costs more the more
// blocks it joins, and no level has work for more (chip_smoke.py's
// level_sweep_checks times this grid against the co-resident one).
//
// Bound: the bytes (rows, the real entries' cols and vals, b, x read once
// and written once).  In practice a deep sweep is held by its chain of
// nlev - 1 grid barriers (the 7-point stencil at nx = 100 has 298 levels
// a sweep in natural order), a shallow one (its colour-ordered ILDU(0):
// 2 levels) by its bytes.
//
// Layout: rows (n,) int64 level by level; cols (n, width) int64 and vals
// (n, width) row-major; level_ptr (nlev + 1,) int64 on the device; b and x
// (n,) contiguous.  dtype codes 0 float32, 1 float64 (the DIA kernels');
// the pairs (values, vector) taken: (0, 0), (1, 1), (0, 1).
//
// Every entry returns a cudaError_t (0 on success) and synchronises
// nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

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

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads)
    level_sweep_kernel(const int64_t* __restrict__ rows, const int64_t* __restrict__ cols,
                       const V* __restrict__ vals, const int64_t* __restrict__ level_ptr,
                       const X* __restrict__ b, X* x, int64_t nlev, int64_t width) {
  using O = Rn<X>;
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t l = 0; l < nlev; ++l) {
    const int64_t hi = level_ptr[l + 1];
    for (int64_t i = level_ptr[l] + first; i < hi; i += stride) {
      const int64_t r = rows[i];
      const int64_t* c = cols + i * width;
      const V* v = vals + i * width;
      X acc = X(0);
      for (int64_t j = 0; j < width; ++j) {
        const int64_t cj = c[j];
        if (cj == r) continue;  // an unused slot
        acc = O::add(acc, O::mul(static_cast<X>(v[j]), __ldcg(x + cj)));
      }
      x[r] = O::sub(b[r], acc);
    }
    if (l + 1 < nlev) grid.sync();
  }
}

// The blocks of a sweep whose widest level holds `max_rows` rows: at most
// the kernel's co-resident maximum, at least 1.
template <typename V, typename X>
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
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_sweep_kernel<V, X>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    per_device[device] = per_sm * sms;
  }
  const int64_t want = (max_rows + kThreads - 1) / kThreads;
  *blocks = want < 1 ? 1 : (want < per_device[device] ? want : per_device[device]);
  return cudaSuccess;
}

template <typename V, typename X>
cudaError_t launch(const void* rows, const void* cols, const void* vals, const void* level_ptr,
                   const void* b, void* x, int64_t nlev, int64_t width, int64_t max_rows,
                   cudaStream_t stream) {
  int64_t blocks = 0;
  cudaError_t err = grid_blocks<V, X>(max_rows, &blocks);
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
  err = cudaLaunchKernelEx(&cfg, level_sweep_kernel<V, X>, static_cast<const int64_t*>(rows),
                           static_cast<const int64_t*>(cols), static_cast<const V*>(vals),
                           static_cast<const int64_t*>(level_ptr), static_cast<const X*>(b),
                           static_cast<X*>(x), nlev, width);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x solving (I + T) x = b over `nlev` levels; `max_rows` the rows of the
// widest level (it sizes the grid).
extern "C" int sigma_level_sweep(int device, int vtype, int xtype, const void* rows,
                                 const void* cols, const void* vals, const void* level_ptr,
                                 const void* b, void* x, int64_t nlev, int64_t width,
                                 int64_t max_rows, void* stream) {
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (vtype == 0 && xtype == 0)
    return launch<float, float>(rows, cols, vals, level_ptr, b, x, nlev, width, max_rows, st);
  if (vtype == 1 && xtype == 1)
    return launch<double, double>(rows, cols, vals, level_ptr, b, x, nlev, width, max_rows, st);
  if (vtype == 0 && xtype == 1)
    return launch<float, double>(rows, cols, vals, level_ptr, b, x, nlev, width, max_rows, st);
  return cudaErrorInvalidValue;
}

