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
// Design: the staged window, value ring and register tile of
// dia_window.cuh (shared with dia_spmm.cu), at G = 4 column groups: a
// block owns 256 consecutive rows and 32 columns (16 with f64 vectors),
// each thread a 4-row x 8-column tile (4 x 4 in f64).  The window is staged
// once per block, or per run of diagonals where the band is wider than the
// window space; values come in 8 KB stages (8 diagonals x 256 rows in f32,
// 16 in bf16, 4 in f64), four buffers, three stages in flight.  Shared
// memory: 110 KB a block, two blocks an SM (the tile's 32 accumulators and
// 32 x values fit the 128 registers that allows; f64 values with f64
// vectors take one block an SM): the ring (32 KB), its offsets and the
// window (548-552 rows, a band of reach 146).  Each value is read from
// device memory once per column group.
//
// More than 32 columns (16 in f64): the grid holds one block per 256 rows
// and column group, the groups of one row block next to each other, so
// they run side by side and the second group's value reads come from L2.
// No partial sums go through y.
//
// Panels: the Panels block-length addressing of dia_spmm.cu, B = m (or n)
// for RHS-major (k, m) panels and B = 1 for (m, k) columns; the five
// (value, vector) dtype pairs.  The values must be 16-byte aligned rows
// (the port's DIA storage always is).
//
// Interface.  One plain C entry point bound with ctypes; it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype pair, a k or a
// panel-block length it does not take.  sigma_dia_spmm_grouped_config
// reports an instantiation's shared memory and window rows.

#include "dia_window.cuh"

namespace {

using namespace sigma_dia;

constexpr int kColGroups = 4;           // threads on one row group: 256 rows a block
constexpr int kStages = 4;              // ring buffers (kStages - 1 in flight)
constexpr int kStageBytes = 8 * 1024;   // values a stage
constexpr int kSmemBytes = 110 * 1024;  // dynamic shared memory a block (2 an SM)

template <typename V, typename X>
using Shape = WindowShape<V, X, kColGroups, kStageBytes, kStages, kSmemBytes, 4>;

template <typename V, typename X>
__global__ void __launch_bounds__(kBlockThreads, (Shape<V, X>::kMinBlocks))
    dia_spmm_grouped_kernel(const V* __restrict__ data, const X* __restrict__ x,
                            const int64_t* __restrict__ offsets, X* __restrict__ y,
                            int64_t D, int64_t stride, int64_t n, int64_t m, int k,
                            Panels px, Panels py, int groups, int route) {
  using S = Shape<V, X>;
  window_spmm_block<S>(data, x, offsets, y, D, stride, n, m, k, px, py, n,
                       static_cast<int64_t>(blockIdx.x / groups) * S::kRows,
                       static_cast<int>(blockIdx.x % groups) * S::kCols, route,
                       /*v_pieces=*/true, /*direct=*/false);
}

template <typename V, typename X>
cudaError_t launch(const void* data, const void* x, const void* offsets, void* y,
                   int64_t D, int64_t stride, int64_t n, int64_t m, int k, Panels px,
                   Panels py, cudaStream_t stream) {
  using S = Shape<V, X>;
  // 16-byte value copies: aligned rows, whole copies within a row
  if (reinterpret_cast<uintptr_t>(data) % 16 || stride % (16 / sizeof(V)))
    return cudaErrorInvalidValue;
  const int groups = (k + S::kCols - 1) / S::kCols;
  const int64_t blocks = (n + S::kRows - 1) / S::kRows * groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = dia_spmm_grouped_kernel<V, X>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int route = pick_route<S>(x, k, px);
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, S::kSmemBytes, stream>>>(
      static_cast<const V*>(data), static_cast<const X*>(x),
      static_cast<const int64_t*>(offsets), static_cast<X*>(y), D, stride, n, m, k, px, py,
      groups, route);
  return cudaGetLastError();
}

template <typename V, typename X>
void config(int64_t* out) {
  using S = Shape<V, X>;
  out[0] = S::kSmemBytes;
  out[1] = S::kWindowRows;
  out[2] = S::kDiags;
  out[3] = S::kStages;
  out[4] = S::kCols;
  out[5] = S::kMinBlocks;
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
