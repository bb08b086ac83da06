// Per-site window statistics for a whole fleet, in one pass over the data.
//
// Replaces the TPU kernel src/repro/kernels/stream_stats/kernel.py::
// stream_stats_fleet_pallas (body _fleet_kernel).  For x of shape (E, k, N),
// f32, contiguous, it writes
//   mom (E, k, 4): S_m = sum_t x^m, m = 1..4, per stream;
//   xxt (E, k, k): X_e X_e^T, the site's own (diagonal) Gram block.
//
// What bounds it: every element of x is read once from device memory and
// used a handful of times (4 power sums, k cross products), so at the fleet
// shapes (E = 1024, k = 8, N = 256: 8.4 MB in, 0.4 MB out, ~48 MFLOP) the
// kernel is bound by memory bandwidth, not arithmetic.
//
// Design.  The TPU kernel walks a sequential (E, N/tn) grid and carries the
// sums in VMEM from one grid step to the next; Hopper's blocks run in no
// order, so the sequential axis becomes loops inside one block per site.
//
// The power sums are taken in the order of the plain version
// (repro_torch/core/stats.py::blocked_sum, itself XLA:CPU's order): the row
// is cut into 32-wide windows (zero padding split evenly between the ends),
// each window is summed left to right, then the window sums are.  One thread
// owns one (stream, window) and sums it sequentially; one thread per
// (stream, moment) then adds the window sums.  Products and sums use the
// _rn intrinsics, which the compiler never contracts into FMAs, so the
// power sums are bitwise the plain version's: the statistics built on them
// cancel catastrophically, and a different rounding would move allocations.
//
// The Gram block stages (k, chunk) tiles of the site in shared memory with
// coalesced loads; each warp owns some of the k(k+1)/2 entries (i <= j),
// its lanes stride over the columns, and a warp-shuffle reduction finishes
// each chunk.  k need not be a multiple of 8: the TPU's zero padding to the
// sublane tile is gone.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 6144;   // k * chunk of the Gram tile, 24 KB
constexpr int kWin = 32;            // reduction window of the power sums
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum a[0], a[stride], ..., a[(len-1)*stride] in blocked_sum's order.
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
stream_stats_fleet_kernel(const float* __restrict__ x, float* __restrict__ mom,
                          float* __restrict__ xxt, int k, int n, int chunk,
                          int nwin, int lo) {
  extern __shared__ float smem[];
  const int npair = k * (k + 1) / 2;
  float* tile = smem;                   // (k, chunk)
  float* part = tile + k * chunk;       // (k, nwin, 4) window sums
  float* acc_g = part + k * nwin * 4;   // (npair,) upper triangle, row-major
  const int e = blockIdx.x;
  const float* xs = x + static_cast<size_t>(e) * k * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // power sums: one thread per (stream, window), left to right
  for (int t = threadIdx.x; t < k * nwin; t += kThreads) {
    const int i = t / nwin;
    const int w = t - i * nwin;
    const int start = w * kWin - lo;
    const float* row = xs + static_cast<size_t>(i) * n;
    float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
    for (int c = max(start, 0); c < min(start + kWin, n); ++c) {
      const float v = row[c];
      const float v2 = __fmul_rn(v, v);
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, v2);
      s3 = __fadd_rn(s3, __fmul_rn(v2, v));
      s4 = __fadd_rn(s4, __fmul_rn(v2, v2));
    }
    float* p = part + (i * nwin + w) * 4;
    p[0] = s1;
    p[1] = s2;
    p[2] = s3;
    p[3] = s4;
  }
  for (int t = threadIdx.x; t < npair; t += kThreads) acc_g[t] = 0.f;

  // Gram block, chunk by chunk
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int len = min(chunk, n - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int t = threadIdx.x; t < k * len; t += kThreads) {
      const int i = t / len;
      const int c = t - i * len;
      tile[i * chunk + c] = xs[static_cast<size_t>(i) * n + c0 + c];
    }
    __syncthreads();
    for (int p = warp; p < npair; p += kWarps) {
      int i = 0;
      int rem = p;
      while (rem >= k - i) {
        rem -= k - i;
        ++i;
      }
      const float* a = tile + i * chunk;
      const float* b = tile + (i + rem) * chunk;
      float g = 0.f;
      for (int c = lane; c < len; c += 32) g += a[c] * b[c];
      g = warp_sum(g);
      if (lane == 0) acc_g[p] += g;
    }
  }
  __syncthreads();
  float* mo = mom + static_cast<size_t>(e) * k * 4;
  for (int t = threadIdx.x; t < 4 * k; t += kThreads) {
    const int i = t / 4;
    const int m = t - i * 4;
    mo[t] = blocked_reduce(part + i * nwin * 4 + m, nwin, 4);
  }
  float* go = xxt + static_cast<size_t>(e) * k * k;
  for (int t = threadIdx.x; t < k * k; t += kThreads) {
    const int i = t / k;
    const int j = t - i * k;
    const int a = min(i, j);
    const int b = max(i, j);
    go[t] = acc_g[a * k - a * (a - 1) / 2 + (b - a)];
  }
}

}  // namespace

extern "C" int stream_stats_fleet(const float* x, float* mom, float* xxt,
                                  int e, int k, int n, void* stream) {
  const int nwin = (n + kWin - 1) / kWin;
  if (e <= 0 || k <= 0 || n <= 0 || k > 64 || nwin > kWin * kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lo = (nwin * kWin - n) / 2;
  int chunk = (kTileFloats / k) & ~31;
  const int n_up = (n + 31) & ~31;
  if (chunk > n_up) chunk = n_up;
  const size_t smem = sizeof(float) * (static_cast<size_t>(k) * chunk +
                                       static_cast<size_t>(k) * nwin * 4 +
                                       k * (k + 1) / 2);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_stats_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stream_stats_fleet_kernel<<<e, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mom, xxt, k, n, chunk, nwin, lo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stream_stats_fleet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
