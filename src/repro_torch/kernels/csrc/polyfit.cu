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
// flops, so at the main path's shape (R = E*k = 8192 rows, N = 256:
// 16.8 MB in, 0.4 MB out) and at a fleet larger than L2 (R = 32768,
// N = 1024: 268 MB) the kernel is bound by device-memory bandwidth.
//
// Design.  The TPU kernel tiles (TK, TN) into VMEM and carries the sums
// across the sequential chunk axis of its grid.  Here persistent blocks
// each take groups of rows (cut into chunks of windows when one row does
// not fit a stage) and stream the tiles of y and u through a two-stage
// ring in shared memory (window_tiles.cuh: cp.async, 16-byte copies where
// aligned, a window-major layout of pitch 36 without bank conflicts), so
// each element is read from device memory once and the next tile lands
// while this one is summed.  The sums are taken in the plain version's
// order (repro_torch/core/stats.py::blocked_sum): one thread sums one
// (row, window) left to right, and one thread per (row, sum) adds the
// window sums in blocked_sum's order, carried across chunks in shared
// memory.  Each (row, window) has two threads: one for the six powers of
// u, one for the four sums of y; the host picks the rows of a tile so that
// every thread of the block has one.  The powers are the plain version's
// products (u^3 = u*u^2, u^5 = u*u^4, u^6 = u^2*u^4) and every product and
// sum uses the _rn intrinsics, which the compiler never contracts into
// FMAs, so the result is bitwise the plain version's.
#include <cuda_runtime.h>

#include <algorithm>

#include "window_tiles.cuh"

namespace {

using wt::kPitch;
using wt::kThreads;
constexpr int kSums = 10;   // u^1..u^6, y*u^0..y*u^3

struct Params {
  int rows, n, nwin, lo, lo2;
  int tile_rows;   // rows per group
  int nwc, nch;    // windows per chunk, chunks per group
  int groups;
  int vec;         // 16-byte copies
};

__global__ void __launch_bounds__(kThreads, 2)
polyfit_kernel(const float* __restrict__ y, const float* __restrict__ u,
               float* __restrict__ pu, float* __restrict__ py,
               const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int row_pitch = p.nwc * kPitch;
  const int tile_floats = p.tile_rows * row_pitch;
  float* stage = smem;                          // 2 stages of (y, u) tiles
  float* part = smem + 4 * tile_floats;         // window sums, part_index
  float* cur_s = part + p.nwc * (kSums * p.tile_rows + 1);  // (10, rows)
  float* tot_s = cur_s + p.tile_rows * kSums;
  const int tid = threadIdx.x;

  const int my_groups = p.groups > static_cast<int>(blockIdx.x)
      ? (p.groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int tiles = my_groups * p.nch;

  auto prefetch = [&](int i) {
    const int g = blockIdx.x + (i / p.nch) * gridDim.x;
    const int c = i - (i / p.nch) * p.nch;
    const int w0 = c * p.nwc;
    const int r0 = g * p.tile_rows;
    const int nr = min(p.tile_rows, p.rows - r0);
    const int nw = min(p.nwc, p.nwin - w0);
    float* st = stage + (i & 1) * 2 * tile_floats;
    const size_t off = static_cast<size_t>(r0) * p.n;
    wt::load_tile(st, y + off, nr, nw, p.nwc, w0, p.n, p.lo, p.vec);
    wt::load_tile(st + tile_floats, u + off, nr, nw, p.nwc, w0, p.n, p.lo,
                  p.vec);
  };

  if (tiles > 0) prefetch(0);
  wt::cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) prefetch(i + 1);
    wt::cp_async_commit();
    wt::cp_async_wait_one();
    __syncthreads();   // tile i has landed for every thread

    const int g = blockIdx.x + (i / p.nch) * gridDim.x;
    const int c = i - (i / p.nch) * p.nch;
    const int w0 = c * p.nwc;
    const int nw = min(p.nwc, p.nwin - w0);
    const int r0 = g * p.tile_rows;
    const int nr = min(p.tile_rows, p.rows - r0);
    const float* ty = stage + (i & 1) * 2 * tile_floats;
    const float* tu = ty + tile_floats;

    // one thread per (half, row, window): half 0 the powers of u, half 1
    // the sums of y; the halves are warp-uniform wherever nr * nw is a
    // multiple of 32
    const int pairs = nr * nw;
    for (int t = tid; t < 2 * pairs; t += kThreads) {
      const int half = t >= pairs;
      const int rw = t - half * pairs;
      const int r = rw / nw;
      const int w = rw - r * nw;
      const int off = (r * p.nwc + w) * kPitch;
      const float4* wu = reinterpret_cast<const float4*>(tu + off);
      if (half == 0) {
        float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < wt::kWin / 4; ++q) {
          const float4 u4 = wu[q];
          const float us[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float uv = us[j];
            const float u2 = __fmul_rn(uv, uv);
            const float u4v = __fmul_rn(u2, u2);
            s[0] = __fadd_rn(s[0], uv);
            s[1] = __fadd_rn(s[1], u2);
            s[2] = __fadd_rn(s[2], __fmul_rn(uv, u2));
            s[3] = __fadd_rn(s[3], u4v);
            s[4] = __fadd_rn(s[4], __fmul_rn(uv, u4v));
            s[5] = __fadd_rn(s[5], __fmul_rn(u2, u4v));
          }
        }
#pragma unroll
        for (int m = 0; m < 6; ++m)
          part[wt::part_index(w, m, r, kSums, p.tile_rows)] = s[m];
      } else {
        const float4* wy = reinterpret_cast<const float4*>(ty + off);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < wt::kWin / 4; ++q) {
          const float4 u4 = wu[q];
          const float4 y4 = wy[q];
          const float us[4] = {u4.x, u4.y, u4.z, u4.w};
          const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float uv = us[j];
            const float yv = ys[j];
            const float u2 = __fmul_rn(uv, uv);
            s[0] = __fadd_rn(s[0], yv);
            s[1] = __fadd_rn(s[1], __fmul_rn(yv, uv));
            s[2] = __fadd_rn(s[2], __fmul_rn(yv, u2));
            s[3] = __fadd_rn(s[3], __fmul_rn(yv, __fmul_rn(uv, u2)));
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
          part[wt::part_index(w, 6 + m, r, kSums, p.tile_rows)] = s[m];
      }
    }
    __syncthreads();   // part complete; the stage may be reused

    // the window sums in blocked_sum's order, carried across chunks
    const bool last = c == p.nch - 1;
    for (int t = tid; t < nr * kSums; t += kThreads) {
      const int m = t / nr;
      const int r = t - m * nr;
      float cur = c == 0 ? 0.f : cur_s[t];
      float tot = c == 0 ? 0.f : tot_s[t];
      int outer = wt::window_of_prev(w0, p.lo2);
#pragma unroll 8
      for (int w = 0; w < nw; ++w)
        wt::add_window_sum(cur, tot, outer, w0 + w, p.lo2,
                           part[wt::part_index(w, m, r, kSums, p.tile_rows)]);
      if (!last) {
        cur_s[t] = cur;
        tot_s[t] = tot;
        continue;
      }
      const size_t row = static_cast<size_t>(r0 + r);
      const float v = __fadd_rn(tot, cur);
      if (m < 6) {
        pu[row * 7 + m + 1] = v;
      } else {
        py[row * 4 + m - 6] = v;
      }
      if (m == 0) pu[row * 7] = static_cast<float>(p.n);
    }
  }
}

}  // namespace

extern "C" int polyfit_moments(const float* y, const float* u, float* pu,
                               float* py, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0 || n > wt::kWin * wt::kWin * wt::kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const wt::Windows win = wt::windows_of(n);
  Params p;
  p.rows = rows;
  p.n = n;
  p.nwin = win.nwin;
  p.lo = win.lo;
  p.lo2 = win.lo2;
  // tiles of about kThreads / 2 (row, window) pairs (two threads each)
  // within one stage; a row too large for a stage is cut into chunks
  const int row_floats = 2 * win.nwin * kPitch;   // y and u
  if (row_floats <= wt::kStageFloats) {
    p.nwc = win.nwin;
    int r = wt::kStageFloats / row_floats;
    r = std::min(r, std::max(1, kThreads / 2 / win.nwin));
    p.tile_rows = std::max(1, std::min(r, rows));
  } else {
    p.tile_rows = 1;
    p.nwc = wt::kStageFloats / (2 * kPitch);
  }
  p.nch = (win.nwin + p.nwc - 1) / p.nwc;
  p.groups = (rows + p.tile_rows - 1) / p.tile_rows;
  p.vec = n % 4 == 0 && p.lo % 4 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const size_t tile = static_cast<size_t>(p.tile_rows) * p.nwc;
  const size_t smem = sizeof(float) *
      (4 * tile * kPitch +
       static_cast<size_t>(p.nwc) * (kSums * p.tile_rows + 1) +
       2 * p.tile_rows * kSums);
  int grid = 0;
  cudaError_t err = wt::persistent_grid(polyfit_kernel, smem, p.groups, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  polyfit_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, u, pu, py, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* polyfit_moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
