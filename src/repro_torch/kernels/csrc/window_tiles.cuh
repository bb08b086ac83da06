// Staging and reduction order shared by the fleet path's two kernels
// (stream_stats_fleet.cu, polyfit.cu).
//
// Both kernels take per-row sums over the last axis of a row-major (rows, N)
// f32 array in the order of the plain version
// (repro_torch/core/stats.py::blocked_sum, XLA:CPU's order): the row is cut
// into nwin = ceil(N / 32) windows of 32 with the zero padding split between
// the ends (lo = (32 nwin - N) / 2 zeros first), each window is summed left
// to right, then the window sums are reduced the same way (windows of 32
// window sums, lo2 zeros first, when nwin > 32; left to right otherwise).
// Adding a zero leaves a sum that starts at +0 unchanged, so the padding may
// be summed or skipped alike.
//
// The tile.  A block stages a tile of rows x nwc windows in shared memory,
// window-major: element j of window w of tile row r sits at
// (r nwc + w) kPitch + j, with 32 values and 4 floats of padding per window.
// Window starts are 16-byte aligned, so a thread reads its window as eight
// float4; the 36-float pitch puts the windows of eight neighbouring
// threads on distinct banks (offsets 4 apart mod 32), so a quarter-warp's
// 128-bit reads never conflict, and a warp reading one column of many rows
// (lanes on consecutive j) does not either.  Positions outside [0, N) are
// zero.
//
// The copy.  cp.async, started by every thread, consecutive threads on
// consecutive addresses: 16 bytes a copy where rows, windows and the base
// are 16-byte aligned (N % 4 == 0, lo % 4 == 0), else 4 bytes a copy.  The
// copy bypasses registers, so a block computes one tile while the next
// lands in the other half of a two-stage ring.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 32;     // reduction window of blocked_sum
constexpr int kPitch = 36;   // floats per staged window
// floats of one stage of the ring (40 KB): two stages and the kernels'
// other buffers stay under half of an SM's shared memory, so two blocks
// share an SM
constexpr int kStageFloats = 10240;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage windows w0 .. w0 + nw - 1 of ``rows`` rows starting at ``src``
// (row stride n) into ``dst`` (row pitch nwc windows).  Every thread of the
// block calls it; the copies complete with the caller's next commit group.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, int nw, int nwc, int w0,
                                          int n, int lo, bool vec) {
  const int quads = rows * nw * (kWin / 4);
  // quad q is column quad jq of window w of row r; a step of kThreads
  // quads keeps jq and moves (r, w) on by kThreads / 8 windows
  const int jq = threadIdx.x & 7;
  int r = (threadIdx.x >> 3) / nw;
  int w = (threadIdx.x >> 3) - r * nw;
  const int dr = (kThreads >> 3) / nw;
  const int dw = (kThreads >> 3) - dr * nw;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    float* d = dst + (r * nwc + w) * kPitch + 4 * jq;
    const int c = (w0 + w) * kWin + 4 * jq - lo;
    const float* s = src + static_cast<size_t>(r) * n;
    if (vec) {
      // N % 4 == lo % 4 == 0: a quad lies wholly inside or outside [0, N)
      if (c >= 0 && c < n) {
        cp_async16(d, s + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c + i >= 0 && c + i < n) {
          cp_async4(d + i, s + c + i);
        } else {
          d[i] = 0.f;
        }
      }
    }
    r += dr;
    w += dw;
    if (w >= nw) {
      w -= nw;
      ++r;
    }
  }
}

// The window sums of a tile wait in shared memory for the second level,
// (window, sum, row) with a pitch of sums * rows + 1 floats per window: a
// thread per (row, window) writes its window's sums, and a thread per (sum,
// row) walks the windows, both without bank conflicts where a warp's lanes
// run over windows (writers) or rows (walkers).
__device__ __forceinline__ int part_index(int w, int m, int r, int sums,
                                          int rows) {
  return w * (sums * rows + 1) + m * rows + r;
}

// The second level of blocked_sum, streamed: window sums arrive in order,
// ``cur`` is the running sum of the current window of window sums and
// ``tot`` the running sum of the finished ones; ``outer`` is the window of
// window sums that window w - 1 fell in.  The result is tot + cur.
__device__ __forceinline__ void add_window_sum(float& cur, float& tot,
                                               int& outer, int w, int lo2,
                                               float s) {
  const int b = (w + lo2) >> 5;
  if (b != outer) {
    tot = __fadd_rn(tot, cur);
    cur = 0.f;
    outer = b;
  }
  cur = __fadd_rn(cur, s);
}

// which window of window sums window w - 1 fell in (0 before the first)
__device__ __forceinline__ int window_of_prev(int w, int lo2) {
  return w == 0 ? 0 : (w - 1 + lo2) >> 5;
}

// host: the windows of a row of n values and the padding of both levels
struct Windows {
  int nwin, lo, lo2;
};

inline Windows windows_of(int n) {
  Windows p;
  p.nwin = (n + kWin - 1) / kWin;
  p.lo = (p.nwin * kWin - n) / 2;
  const int nw2 = (p.nwin + kWin - 1) / kWin;
  p.lo2 = p.nwin > kWin ? (nw2 * kWin - p.nwin) / 2 : 0;
  return p;
}

// host: blocks for ``groups`` work groups, as many as fit on the card at
// once (persistent blocks), at most one per group
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int groups, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long cap = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(groups < cap ? groups : cap);
  return cudaSuccess;
}

}  // namespace wt
