// The scalar tail of one Arnoldi step of restarted GMRES, for Hopper
// (sm_90a): the CGS2 column's assembly and breakdown test, then the Givens
// update.
//
// Replaces no Pallas kernel: it is the port's counterpart of the tail of
// ``sigma_tpu/solvers/krylov.py`` ``_cgs2_column`` and of
// ``_givens_update``, which XLA fuses on the device inside the compiled
// GMRES and FGMRES loops.  Step j of a restart cycle hands it the two CGS2
// projections h1, h2 (j + 1 entries each, reduced over the ranks) and
// ||w||, all in b's dtype.  It forms the Hessenberg column
// h = [h1 + h2, ||w||] in the small dtype (b's, the 16-bit floats widened
// to float32), zeroes h[j + 1] on a breakdown (||w|| <= eps10) and writes
// the divisor of the next basis row, ||w|| or inf on a breakdown (so w / d
// is w's normalised form or zeros, with no host read).  It then applies
// the j rotations of the earlier steps to h, makes the rotation that
// annihilates h[j + 1], and folds it into the triangular factor R
// (column j), the rotations cs, sn and the rotated right-hand side g.
// |g[j + 1]| is the running residual estimate; from it the kernel writes
// the predicate of the next step, (est > tol) & (j + 1 < m) &
// (k + j + 1 < maxiter), where k is the device count of the steps before
// this cycle, and the cycle's step count j + 1.  So a captured step needs
// no host read.
//
// One warp, one launch a step, no shared memory.  Every load is issued
// before the first rotation: the scalars, and the 32 lanes' cs[i], sn[i]
// and h[i + 1] (i = lane) together, coalesced.  The rotations are a chain,
// each one's h[i] the last one's output, so they stay a serial chain in
// the same order, run from registers: rotation t's values are broadcast
// from lane t (``__shfl_sync``, independent of the chain, so they issue
// ahead of it) and every lane does the same operations, lane t keeping
// R[i, j].  Past 32 rotations the chain goes on a chunk of 32 at a time,
// each chunk's loads issued before the chunk before it runs.  Every
// operation is the correctly rounded one (``__fmul_rn`` and friends: no
// contraction into an FMA, no reassociation), so the result is the plain
// PyTorch version's bit for bit, which does the same operations in the
// same order.  A 16-bit h1 + h2 rounds as PyTorch's add does: in float32,
// then once to b's type.  The lanes write R's column and h back in
// parallel, lane 0 the scalars.
//
// Registers, not shared memory: with R's entries stored to shared memory
// in the chain's loop, the compiler cannot move a pass's loads above the
// last pass's store, and each rotation waits on a shared-memory load.
//
// Layout: R is (m, m) row-major, R[i, j] = R[i * m + j]; h1, h2, h, cs, sn
// and g are contiguous; wn and d 0-d in b's dtype; eps10, est and tol 0-d
// in the small dtype; inner a 0-d bool; jdev and k 0-d int64.
//
// Bound: latency.  It moves ~(2 b + 5 s)(j + 1) bytes (b, s the two
// dtypes' sizes) and does ~7 j operations; the chain is j dependent
// multiply-adds behind one round trip to L2 and one launch.
//
// Every entry returns a cudaError_t (0 on success) and synchronises
// nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// b's dtype B beside the small dtype T: h1 + h2 rounded in B and widened
// to T (exact), B widened to T, and B's infinity
template <typename B>
struct Wide;

template <>
struct Wide<float> {
  static __device__ float sum(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float widen(float a) { return a; }
  static __device__ float inf() { return __int_as_float(0x7f800000); }
};

template <>
struct Wide<double> {
  static __device__ double sum(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double widen(double a) { return a; }
  static __device__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

template <>
struct Wide<__nv_bfloat16> {
  static __device__ float sum(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __bfloat162float(
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b))));
  }
  static __device__ float widen(__nv_bfloat16 a) { return __bfloat162float(a); }
  static __device__ __nv_bfloat16 inf() { return __ushort_as_bfloat16(0x7f80); }
};

template <>
struct Wide<__half> {
  static __device__ float sum(__half a, __half b) {
    return __half2float(__float2half_rn(__fadd_rn(__half2float(a), __half2float(b))));
  }
  static __device__ float widen(__half a) { return __half2float(a); }
  static __device__ __half inf() { return __ushort_as_half(0x7c00); }
};

constexpr unsigned kFull = 0xffffffffu;

template <typename B, typename T>
__global__ void __launch_bounds__(32)
    givens_update_kernel(const B* __restrict__ h1, const B* __restrict__ h2,
                         const B* __restrict__ wn, const T* __restrict__ eps10,
                         T* __restrict__ h, B* __restrict__ d, T* __restrict__ R,
                         T* __restrict__ cs, T* __restrict__ sn, T* __restrict__ g,
                         T* __restrict__ est, bool* __restrict__ inner,
                         int64_t* __restrict__ jdev, const int64_t* __restrict__ k,
                         const T* __restrict__ tol, int j, int m, int64_t maxiter) {
  using O = Rn<T>;
  using W = Wide<B>;
  const int lane = threadIdx.x;

  // every load first: the scalars (one address for all lanes), h[0], and
  // each lane's rotation i = lane of the first chunk: cs[i], sn[i] and
  // the column's next entry h[i + 1]
  const int64_t kv = *k;
  const B wv = *wn;
  const T eps = *eps10, tv = *tol, gj = g[j];
  const T h0 = W::sum(h1[0], h2[0]);
  T cur = h0;
  T c = T(0), s = T(0), next = T(0);
  if (lane < j) {
    c = cs[lane];
    s = sn[lane];
    next = W::sum(h1[lane + 1], h2[lane + 1]);
  }

  // the earlier rotations, a chunk of 32 at a time:
  // (h[i], h[i+1]) <- (c h[i] + s h[i+1], -s h[i] + c h[i+1]).  Every lane
  // runs the chain on rotation t's values broadcast from lane t (the same
  // operations in every lane), and lane t keeps R[i, j] for the write-back;
  // the next chunk's loads are issued before this chunk's chain
  for (int base = 0; base < j; base += 32) {
    const int ahead = base + 32 + lane;
    T c2 = T(0), s2 = T(0), next2 = T(0);
    if (ahead < j) {
      c2 = cs[ahead];
      s2 = sn[ahead];
      next2 = W::sum(h1[ahead + 1], h2[ahead + 1]);
    }
    T mine = T(0);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const T ct = __shfl_sync(kFull, c, t), st = __shfl_sync(kFull, s, t);
      const T nt = __shfl_sync(kFull, next, t);
      if (base + t < j) {
        const T r = O::add(O::mul(ct, cur), O::mul(st, nt));
        cur = O::add(O::mul(-st, cur), O::mul(ct, nt));
        if (lane == t) mine = r;
      }
    }
    const int i = base + lane;
    if (i < j) {
      R[static_cast<int64_t>(i) * m + j] = mine;
      h[i + 1] = next;
    }
    c = c2;
    s = s2;
    next = next2;
  }

  // the breakdown: h[j + 1] = ||w|| * ok, the divisor ||w|| or inf; then
  // the new rotation, annihilating h[j + 1] (every lane alike, lane 0
  // writes)
  const T wide = W::widen(wv);
  const bool ok = wide > eps;
  const T low = O::mul(wide, ok ? T(1) : T(0));
  const T denom = O::sqrt(O::add(O::mul(cur, cur), O::mul(low, low)));
  T cn = T(1), sj = T(0);
  if (denom > T(0)) {
    cn = O::div(cur, denom);
    sj = O::div(low, denom);
  }
  if (lane == 0) {
    h[0] = h0;
    h[j + 1] = low;
    *d = ok ? wv : W::inf();
    R[static_cast<int64_t>(j) * m + j] = denom;
    cs[j] = cn;
    sn[j] = sj;
    const T next_g = O::mul(-sj, gj);
    g[j] = O::mul(cn, gj);
    g[j + 1] = next_g;
    const T e = fabs(next_g);
    *est = e;
    *inner = e > tv && j + 1 < m && kv + j + 1 < maxiter;
    *jdev = j + 1;
  }
}

template <typename B, typename T>
cudaError_t launch(void* h1, void* h2, void* wn, void* eps10, void* h, void* d, void* R,
                   void* cs, void* sn, void* g, void* est, void* inner, void* jdev,
                   const void* k, const void* tol, int64_t j, int64_t m, int64_t maxiter,
                   cudaStream_t stream) {
  if (j < 0 || j >= m || m > INT32_MAX) return cudaErrorInvalidValue;
  givens_update_kernel<B, T><<<1, 32, 0, stream>>>(
      static_cast<const B*>(h1), static_cast<const B*>(h2), static_cast<const B*>(wn),
      static_cast<const T*>(eps10), static_cast<T*>(h), static_cast<B*>(d),
      static_cast<T*>(R), static_cast<T*>(cs), static_cast<T*>(sn), static_cast<T*>(g),
      static_cast<T*>(est), static_cast<bool*>(inner), static_cast<int64_t*>(jdev),
      static_cast<const int64_t*>(k), static_cast<const T*>(tol), static_cast<int>(j),
      static_cast<int>(m), maxiter);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(32) empty_warp_kernel() {}

}  // namespace

// b's dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16 (the small arrays
// float64 for 1, float32 for the rest)
extern "C" int sigma_givens_update(int device, int dtype, void* h1, void* h2, void* wn,
                                   void* eps10, void* h, void* d, void* R, void* cs, void* sn,
                                   void* g, void* est, void* inner, void* jdev, const void* k,
                                   const void* tol, int64_t j, int64_t m, int64_t maxiter,
                                   void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
#define SIGMA_GIVENS_ARGS h1, h2, wn, eps10, h, d, R, cs, sn, g, est, inner, jdev, k, tol, j, m, \
                          maxiter, st
  switch (dtype) {
    case 0: return launch<float, float>(SIGMA_GIVENS_ARGS);
    case 1: return launch<double, double>(SIGMA_GIVENS_ARGS);
    case 2: return launch<__nv_bfloat16, float>(SIGMA_GIVENS_ARGS);
    case 3: return launch<__half, float>(SIGMA_GIVENS_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SIGMA_GIVENS_ARGS
}

// An empty one-warp kernel: the floor a one-warp launch costs, timed beside
// the Givens kernel.  Counted nowhere.
extern "C" int sigma_empty_warp(int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  empty_warp_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
