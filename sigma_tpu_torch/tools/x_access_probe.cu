// How the thread-to-row map of a register tile meets the L1, on the access
// pattern of the symmetric DIA SpMM (dia_spmm.cu's dia_sym_spmm) on the
// nx=216 stencil at k = 8: each thread owns 4 rows x 8 columns, reads 4
// diagonals' values (upper and mirror) and x at the row shifts 0, +-1,
// +-216 and +-46656, and stores y.  Two maps of a warp's 128 rows (4
// consecutive rows a thread, or rows lane + 32 q) for two layouts of x and
// y ((n, 8) columns, whose rows are read as two 16-byte pieces, and (8, n)
// RHS-major panels).  Prints each kernel's median time of 20 launches
// (CUDA events) on zero data.  Build and run on an sm_90a card:
//
//     mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//         -o build/x_access_probe sigma_tpu_torch/tools/x_access_probe.cu && build/x_access_probe
#include <cstdio>
#include <cstdint>
#include <vector>
#include <algorithm>
#include <cuda_runtime.h>
constexpr int R = 4, C = 8;
__constant__ int64_t c_off[4] = {0, 1, 216, 46656};

__device__ __forceinline__ int64_t clampi(int64_t r, int64_t n) { return r < 0 ? 0 : r >= n ? n - 1 : r; }

template <bool kStrided>
__global__ void __launch_bounds__(128) cols_kernel(const float* __restrict__ data, const float* __restrict__ x,
                                                   float* __restrict__ y, int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wbase = (static_cast<int64_t>(blockIdx.x) * 4 + warp) * 128;
  int64_t row[R];
  for (int q = 0; q < R; ++q) row[q] = kStrided ? wbase + lane + 32 * q : wbase + lane * 4 + q;
  if (wbase >= n) return;
  float acc[R][C] = {};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int64_t o = c_off[d];
    float vu[R], vm[R];
    if (kStrided) {
#pragma unroll
      for (int q = 0; q < R; ++q) { vu[q] = __ldg(data + d * n + row[q]); vm[q] = __ldg(data + d * n + clampi(row[q] - o, n)); }
    } else {
      float4 a = __ldg(reinterpret_cast<const float4*>(data + d * n + row[0]));
      vu[0] = a.x, vu[1] = a.y, vu[2] = a.z, vu[3] = a.w;
#pragma unroll
      for (int q = 0; q < R; ++q) vm[q] = __ldg(data + d * n + clampi(row[q] - o, n));
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && o == 0) break;
      const int64_t sh = s ? -o : o;
      float xr[R][C];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4* p = reinterpret_cast<const float4*>(x + clampi(row[q] + sh, n) * C);
        float4 a = __ldg(p), b = __ldg(p + 1);
        xr[q][0] = a.x, xr[q][1] = a.y, xr[q][2] = a.z, xr[q][3] = a.w;
        xr[q][4] = b.x, xr[q][5] = b.y, xr[q][6] = b.z, xr[q][7] = b.w;
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[q][c] = fmaf(s ? vm[q] : vu[q], xr[q][c], acc[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (row[q] >= n) continue;
    float4* p = reinterpret_cast<float4*>(y + row[q] * C);
    p[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    p[1] = make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
  }
}

// panels (C, n): consecutive rows in 16-byte pieces (aligned pieces, shifted by selects)
template <bool kStrided>
__global__ void __launch_bounds__(128) panels_kernel(const float* __restrict__ data, const float* __restrict__ x,
                                                     float* __restrict__ y, int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wbase = (static_cast<int64_t>(blockIdx.x) * 4 + warp) * 128;
  int64_t row[R];
  for (int q = 0; q < R; ++q) row[q] = kStrided ? wbase + lane + 32 * q : wbase + lane * 4 + q;
  if (wbase >= n) return;
  float acc[R][C] = {};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int64_t o = c_off[d];
    float vu[R], vm[R];
#pragma unroll
    for (int q = 0; q < R; ++q) { vu[q] = __ldg(data + d * n + row[q]); vm[q] = __ldg(data + d * n + clampi(row[q] - o, n)); }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && o == 0) break;
      const int64_t sh = s ? -o : o;
      float xr[R][C];
      if (kStrided) {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int q = 0; q < R; ++q) xr[q][c] = __ldg(x + c * n + clampi(row[q] + sh, n));
      } else {
        const int64_t c0 = clampi(row[0] + sh, n - 8);
        const int64_t a0 = c0 & ~int64_t(3);
        const int sft = static_cast<int>(c0 - a0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4* p = reinterpret_cast<const float4*>(x + c * n + a0);
          float4 a = __ldg(p), b = __ldg(p + 1);
          float buf[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int q = 0; q < R; ++q) {
            float v = buf[q];
            v = sft == 1 ? buf[q + 1] : v;
            v = sft == 2 ? buf[q + 2] : v;
            v = sft == 3 ? buf[q + 3] : v;
            xr[q][c] = v;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[q][c] = fmaf(s ? vm[q] : vu[q], xr[q][c], acc[q][c]);
    }
  }
  if (kStrided) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int q = 0; q < R; ++q) if (row[q] < n) y[c * n + row[q]] = acc[q][c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<float4*>(y + c * n + row[0]) = make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
  }
}

template <class K>
float time_it(K kernel, const float* d, const float* x, float* y, int64_t n) {
  const unsigned blocks = static_cast<unsigned>((n + 511) / 512);
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  for (int w = 0; w < 3; ++w) kernel<<<blocks, 128>>>(d, x, y, n);
  std::vector<float> t;
  for (int r = 0; r < 20; ++r) {
    cudaEventRecord(a);
    kernel<<<blocks, 128>>>(d, x, y, n);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b); t.push_back(ms);
  }
  std::sort(t.begin(), t.end());
  return t[t.size() / 2];
}

int main() {
  const int64_t n = 216LL * 216 * 216;
  float *d, *x, *y;
  cudaMalloc(&d, 4 * n * 4); cudaMalloc(&x, n * C * 4); cudaMalloc(&y, n * C * 4);
  cudaMemset(d, 0, 4 * n * 4); cudaMemset(x, 0, n * C * 4);
  printf("cols consecutive %.4f ms\n", time_it(cols_kernel<false>, d, x, y, n));
  printf("cols strided     %.4f ms\n", time_it(cols_kernel<true>, d, x, y, n));
  printf("panels consecutive %.4f ms\n", time_it(panels_kernel<false>, d, x, y, n));
  printf("panels strided     %.4f ms\n", time_it(panels_kernel<true>, d, x, y, n));
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
