// The Givens update of one Arnoldi step of restarted GMRES, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it is the port's counterpart of
// ``sigma_tpu/solvers/krylov.py`` ``_givens_update``, which XLA runs on the
// device inside the compiled GMRES loop.  Step j of a restart cycle hands
// it the new Hessenberg column h[0 .. j + 1]; it applies the j rotations
// of the earlier steps to h, makes the rotation that annihilates h[j + 1],
// and folds it into the triangular factor R (column j), the rotations cs,
// sn and the rotated right-hand side g.  |g[j + 1]| is the running
// residual estimate; from it the kernel writes the predicate of the next
// step, (est > tol) & (j + 1 < m) & (k + j + 1 < maxiter), where k is the
// device count of the steps before this cycle, and the cycle's step count
// j + 1.  So a captured step needs no host read.
//
// One thread: the rotations are a chain, each one's h[i] the last one's
// output.  The loads of cs, sn and h do not depend on the chain and go
// ahead of it.  Every operation is the correctly rounded one (``__fmul_rn``
// and friends: no contraction into an FMA), so the result is the plain
// PyTorch version's bit for bit, which does the same operations in the
// same order.
//
// Layout: R is (m, m) row-major, R[i, j] = R[i * m + j]; h, cs, sn and g
// are contiguous; est and tol 0-d in the same dtype (float32 or float64);
// inner a 0-d bool; jdev and k 0-d int64.
//
// Bound: launch latency.  It moves ~16 (j + 2) bytes and does ~6 j
// operations; the chain is j dependent multiply-adds.
//
// Every entry returns a cudaError_t (0 on success) and synchronises
// nothing.

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

template <typename T>
__global__ void givens_update_kernel(const T* __restrict__ h, T* __restrict__ R,
                                     T* __restrict__ cs, T* __restrict__ sn, T* __restrict__ g,
                                     T* __restrict__ est, bool* __restrict__ inner,
                                     int64_t* __restrict__ jdev, const int64_t* __restrict__ k,
                                     const T* __restrict__ tol, int64_t j, int64_t m,
                                     int64_t maxiter) {
  using O = Rn<T>;
  // the earlier rotations: (h[i], h[i+1]) <- (c h[i] + s h[i+1], -s h[i] + c h[i+1])
  T cur = h[0];
  for (int64_t i = 0; i < j; ++i) {
    const T c = cs[i], s = sn[i], next = h[i + 1];
    R[i * m + j] = O::add(O::mul(c, cur), O::mul(s, next));
    cur = O::add(O::mul(-s, cur), O::mul(c, next));
  }
  // the new rotation, annihilating h[j + 1]
  const T low = h[j + 1];
  const T denom = O::sqrt(O::add(O::mul(cur, cur), O::mul(low, low)));
  T c = T(1), s = T(0);
  if (denom > T(0)) {
    c = O::div(cur, denom);
    s = O::div(low, denom);
  }
  cs[j] = c;
  sn[j] = s;
  const T gj = g[j];
  const T next_g = O::mul(-s, gj);
  g[j] = O::mul(c, gj);
  g[j + 1] = next_g;
  R[j * m + j] = denom;
  const T e = fabs(next_g);
  *est = e;
  *inner = e > *tol && j + 1 < m && *k + j + 1 < maxiter;
  *jdev = j + 1;
}

template <typename T>
cudaError_t launch(void* h, void* R, void* cs, void* sn, void* g, void* est, void* inner,
                   void* jdev, const void* k, const void* tol, int64_t j, int64_t m,
                   int64_t maxiter, cudaStream_t stream) {
  givens_update_kernel<T><<<1, 1, 0, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(R), static_cast<T*>(cs), static_cast<T*>(sn),
      static_cast<T*>(g), static_cast<T*>(est), static_cast<bool*>(inner),
      static_cast<int64_t*>(jdev), static_cast<const int64_t*>(k), static_cast<const T*>(tol), j,
      m, maxiter);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64 (the codes of the DIA kernels' values).
extern "C" int sigma_givens_update(int device, int dtype, void* h, void* R, void* cs, void* sn,
                                   void* g, void* est, void* inner, void* jdev, const void* k,
                                   const void* tol, int64_t j, int64_t m, int64_t maxiter,
                                   void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, R, cs, sn, g, est, inner, jdev, k, tol, j, m, maxiter, st);
  if (dtype == 1) return launch<double>(h, R, cs, sn, g, est, inner, jdev, k, tol, j, m, maxiter, st);
  return cudaErrorInvalidValue;
}
