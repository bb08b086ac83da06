// Vandermonde power sums for the compact-model fits (§IV-B), one pass.
//
// Replaces the TPU kernel src/repro/kernels/polyfit/kernel.py::polyfit_pallas
// (body _kernel).  For y, u of shape (R, N), f32, contiguous, it writes
//   pu (R, 7): pu_m = sum_t u^m,      m = 0..6  (the 4x4 Hankel Gram matrix)
//   py (R, 4): py_m = sum_t y * u^m,  m = 0..3  (the right-hand side)
// pu_0 is written as N; the wrapper overwrites it with the true (masked)
// counts, as the reference's ops.py does.
//
// What bounds it: both inputs are read once and each element feeds ~20
// flops, so at the fleet shape (R = E*k = 8192 rows, N = 256: 16.8 MB in,
// 0.4 MB out) the kernel is bound by device-memory bandwidth.
//
// Design.  The TPU kernel tiles (TK, TN) into VMEM and carries the sums
// across the sequential chunk axis of its grid; here nothing is carried
// across blocks.  The sums are taken in the plain version's order
// (repro_torch/core/stats.py::blocked_sum): each row is cut into 32-wide
// windows (zero padding split evenly between the ends), one thread sums one
// (row, window) left to right for all 10 sums, and one thread per
// (row, sum) adds the window sums from shared memory.  The powers are the
// plain version's products (u^3 = u*u^2, u^5 = u*u^4, u^6 = u^2*u^4) and
// every product and sum uses the _rn intrinsics, which the compiler never
// contracts into FMAs, so the result is bitwise the plain version's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWin = 32;
constexpr int kSums = 10;   // u^1..u^6, y*u^0..y*u^3

__device__ float blocked_reduce(const float* a, int len, int stride) {
  if (len <= kWin) {
    float acc = 0.f;
    for (int i = 0; i < len; ++i) acc = __fadd_rn(acc, a[i * stride]);
    return acc;
  }
  const int nw = (len + kWin - 1) / kWin;    // <= kWin (checked on the host)
  const int lo = (nw * kWin - len) / 2;
  float acc = 0.f;
  for (int w = 0; w < nw; ++w) {
    float s = 0.f;
    const int start = w * kWin - lo;
    for (int j = max(start, 0); j < min(start + kWin, len); ++j)
      s = __fadd_rn(s, a[j * stride]);
    acc = __fadd_rn(acc, s);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
polyfit_kernel(const float* __restrict__ y, const float* __restrict__ u,
               float* __restrict__ pu, float* __restrict__ py, int rows, int n,
               int nwin, int lo, int rows_per_block) {
  extern __shared__ float part[];   // (rows_per_block, nwin, kSums)
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  for (int t = threadIdx.x; t < nr * nwin; t += kThreads) {
    const int r = t / nwin;
    const int w = t - r * nwin;
    const int start = w * kWin - lo;
    const float* yr = y + static_cast<size_t>(r0 + r) * n;
    const float* ur = u + static_cast<size_t>(r0 + r) * n;
    float s[kSums];
#pragma unroll
    for (int m = 0; m < kSums; ++m) s[m] = 0.f;
    for (int c = max(start, 0); c < min(start + kWin, n); ++c) {
      const float uv = ur[c];
      const float yv = yr[c];
      const float u2 = __fmul_rn(uv, uv);
      const float u3 = __fmul_rn(uv, u2);
      const float u4 = __fmul_rn(u2, u2);
      s[0] = __fadd_rn(s[0], uv);
      s[1] = __fadd_rn(s[1], u2);
      s[2] = __fadd_rn(s[2], u3);
      s[3] = __fadd_rn(s[3], u4);
      s[4] = __fadd_rn(s[4], __fmul_rn(uv, u4));
      s[5] = __fadd_rn(s[5], __fmul_rn(u2, u4));
      s[6] = __fadd_rn(s[6], yv);
      s[7] = __fadd_rn(s[7], __fmul_rn(yv, uv));
      s[8] = __fadd_rn(s[8], __fmul_rn(yv, u2));
      s[9] = __fadd_rn(s[9], __fmul_rn(yv, u3));
    }
    float* p = part + (r * nwin + w) * kSums;
#pragma unroll
    for (int m = 0; m < kSums; ++m) p[m] = s[m];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nr * kSums; t += kThreads) {
    const int r = t / kSums;
    const int m = t - r * kSums;
    const float v = blocked_reduce(part + r * nwin * kSums + m, nwin, kSums);
    const size_t row = static_cast<size_t>(r0 + r);
    if (m < 6) {
      pu[row * 7 + m + 1] = v;
    } else {
      py[row * 4 + m - 6] = v;
    }
    if (m == 0) pu[row * 7] = static_cast<float>(n);
  }
}

}  // namespace

extern "C" int polyfit_moments(const float* y, const float* u, float* pu,
                               float* py, int rows, int n, void* stream) {
  const int nwin = (n + kWin - 1) / kWin;
  if (rows <= 0 || n <= 0 || nwin > kWin * kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lo = (nwin * kWin - n) / 2;
  int rows_per_block = kThreads / nwin;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = sizeof(float) * rows_per_block * nwin * kSums;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        polyfit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  polyfit_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, u, pu, py, rows, n, nwin, lo, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* polyfit_moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
