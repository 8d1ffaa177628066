// The row-tile helpers shared by the DIA SpMV kernels (dia_spmv.cu) and the
// symmetric DIA SpMM (dia_spmm.cu): a thread's values of a diagonal as raw
// bits in 16-byte pieces, the mirror's two pieces, offsets staged with
// their value-row bases, and the one-wave launch.
#pragma once

#include "dia_window.cuh"  // cp.async helpers, fma_x, load_piece, store_piece

namespace sigma_dia {

// rows a thread: one 16-byte piece of a value row
template <typename V>
__host__ __device__ constexpr int rows_of() {
  return 16 / static_cast<int>(sizeof(V));
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

// The R mirror values of #2 as loaded: the two aligned pieces that hold
// val(d, j0 .. j0 + R), j0 = i0 - o (the second = the first where j0 is
// aligned, so the load needs no branch), and one of them by element.
template <typename V>
union MirrorPieces {
  uint4 raw[2];
  typename Bits<V>::T b[2 * (16 / sizeof(V))];
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

// Make `device` current unless it is.
inline cudaError_t use_device(int device) {
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

}  // namespace sigma_dia
