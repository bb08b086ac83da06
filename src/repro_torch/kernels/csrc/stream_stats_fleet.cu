// Per-site window statistics for a whole fleet, in one pass over the data.
//
// Replaces the TPU kernel src/repro/kernels/stream_stats/kernel.py::
// stream_stats_fleet_pallas (body _fleet_kernel).  For x of shape (E, k, N),
// f32, contiguous, it writes
//   mom (E, k, 4): S_m = sum_t x^m, m = 1..4, per stream;
//   xxt (E, k, k): X_e X_e^T, the site's own (diagonal) Gram block.
//
// What bounds it: every element of x is read once from device memory and
// used a handful of times (4 power sums, k cross products): at the main
// path's shape (E = 1024, k = 8, N = 256: 8.4 MB in, 0.4 MB out, ~48 MFLOP)
// and at a fleet larger than L2 (E = 4096, k = 8, N = 1024: 134 MB,
// 0.77 GFLOP) the kernel is bound by memory bandwidth, not arithmetic.
//
// Design.  The TPU kernel walks a sequential (E, N/tn) grid and carries the
// sums in VMEM from one grid step to the next.  Here persistent blocks (as
// many as fit on the card) each take groups of G whole sites; a group is
// cut into chunks of nwc windows when one site does not fit a stage.  The
// tiles (G k rows x nwc windows) stream through a two-stage ring in shared
// memory (window_tiles.cuh: cp.async, 16-byte copies where aligned, a
// window-major layout of pitch 36 without bank conflicts), so each element
// is read from device memory once and the next tile lands while this one
// is summed.  The host picks G so that a tile holds about 256 (stream,
// window) pairs.  The block's warps split the tile's work: the Gram warps
// (half of them at k <= 8, seven of eight above) take the Gram block, the
// others the power sums, side by side, each group meeting at a barrier of
// its own; one barrier of the whole block per tile frees the stage.
//
// Power sums: one thread per (stream, window) sums its window left to
// right, the four moments as independent accumulators; one thread per
// (stream, moment) then adds the window sums in blocked_sum's order,
// carried across chunks in shared memory.  A row of one window (N <= 32)
// with ``fused`` set sums S2..S4 as chains of fused multiply-adds instead
// (core/stats.py::product_sum: the caller says which order its reduction
// gets in the reference).  Products and sums use the _rn intrinsics, which
// the compiler never contracts into FMAs, so the power sums are bitwise
// the plain version's: the statistics built on them cancel
// catastrophically, and a different rounding would move allocations.
//
// Gram block: each entry (i <= j) of a site is summed in the order of the
// plain version (core/stats.py::lane_sum with 4 lanes, the order of the
// reference's compiled dot): product p of the first m = N - N % 4 goes
// into chain p % 4 by __fmaf_rn, in column order, the chains carried
// across chunks in shared memory; the chains are added as
// (c0 + c1) + (c2 + c3), and the last N % 4 products, rounded and added
// left to right, are added last.  One Gram thread owns one (site, entry,
// chain) of the tile at a time and walks its N / 4 columns; at the end of
// the group one thread per (site, entry) adds the chains and the tail and
// writes both halves of the symmetric block.  No atomics: the result is
// bitwise the plain version's, on every run.  Tensor cores are not used:
// TF32 would not hold the order, nor 2e-5.
#include <cuda_runtime.h>

#include <algorithm>

#include "window_tiles.cuh"

namespace {

using wt::kPitch;
using wt::kThreads;
using wt::kWarps;

struct Params {
  int e, k, n, nwin, lo, lo2;
  int sites;      // G: sites per group
  int nwc, nch;   // windows per chunk, chunks per group
  int groups;
  int npairs;     // Gram entries (i <= j) of a site: k (k + 1) / 2
  int m4;         // products in the four chains: N - N % 4
  int gram_warps; // warps on the Gram block; the rest take the power sums
  int vec;        // 16-byte copies
  int fma_sums;   // S2..S4 of a one-window row as fused multiply-adds
};

// rows (i, j), i <= j, of Gram entry q in row-major upper-triangle order
__device__ __forceinline__ void entry_rows(int q, int k, int& i, int& j) {
  i = 0;
  while (q >= k - i) {
    q -= k - i;
    ++i;
  }
  j = i + q;
}

// wait at barrier ``id`` (1..15) for the ``count`` threads of some warps
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The Gram warps' share of a tile: each (site, entry, chain) of the group
// carries its chain over the tile's columns, and at the end of the group
// each site's block is written from the chains and the tail.
__device__ __forceinline__ void gram_tile(const float* tile, float* chains,
                                          const Params p, int sites, int w0,
                                          int nw, int c, bool last,
                                          int row_pitch, int site0,
                                          float* __restrict__ xxt) {
  const int tid = threadIdx.x;
  const int gram_threads = p.gram_warps * 32;
  // data column of the tile's column 0 (the staging pads lo zeros first)
  const int col0 = w0 * wt::kWin - p.lo;
  const int first = max(0, -col0);
  const int end = min(nw * wt::kWin, p.m4 - col0);
  for (int t = tid; t < sites * p.npairs * 4; t += gram_threads) {
    const int q = t & 3;
    const int se = t >> 2;
    const int gs = se / p.npairs;
    int i, j;
    entry_rows(se - gs * p.npairs, p.k, i, j);
    const float* ra = tile + (gs * p.k + i) * row_pitch;
    const float* rb = tile + (gs * p.k + j) * row_pitch;
    float acc = c == 0 ? 0.f : chains[t];
    // the columns whose data column is q mod 4, in order
    for (int col = first + ((q - col0 - first) & 3); col < end; col += 4) {
      const int off = (col >> 5) * kPitch + (col & 31);
      acc = __fmaf_rn(ra[off], rb[off], acc);
    }
    chains[t] = acc;
  }
  if (!last) return;
  named_barrier(2, gram_threads);   // every chain of the group

  const int kk = p.k * p.k;
  for (int se = tid; se < sites * p.npairs; se += gram_threads) {
    const int gs = se / p.npairs;
    int i, j;
    entry_rows(se - gs * p.npairs, p.k, i, j);
    const float* ch = chains + 4 * se;
    float v = __fadd_rn(__fadd_rn(ch[0], ch[1]), __fadd_rn(ch[2], ch[3]));
    if (p.m4 < p.n) {
      // the tail lies in the row's last window, so in this tile
      const float* ra = tile + (gs * p.k + i) * row_pitch;
      const float* rb = tile + (gs * p.k + j) * row_pitch;
      float tail = 0.f;
      for (int d = p.m4; d < p.n; ++d) {
        const int col = d - col0;
        const int off = (col >> 5) * kPitch + (col & 31);
        tail = __fadd_rn(tail, __fmul_rn(ra[off], rb[off]));
      }
      v = __fadd_rn(v, tail);
    }
    float* out = xxt + static_cast<size_t>(site0 + gs) * kk;
    out[i * p.k + j] = v;
    out[j * p.k + i] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
stream_stats_fleet_kernel(const float* __restrict__ x, float* __restrict__ mom,
                          float* __restrict__ xxt, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int rows = p.sites * p.k;              // tile rows
  const int row_pitch = p.nwc * kPitch;
  const int stage_floats = rows * row_pitch;
  float* stage = smem;                         // 2 stages
  float* part = smem + 2 * stage_floats;       // window sums, part_index
  float* cur_s = part + p.nwc * (4 * rows + 1);   // (4, rows) carried sums
  float* tot_s = cur_s + rows * 4;
  float* chains = tot_s + rows * 4;            // (sites, npairs, 4) Gram
  const int tid = threadIdx.x;
  // warps [0, gram_warps) take the Gram block, the others the power sums
  const int gram_threads = p.gram_warps * 32;
  const int sum_threads = kThreads - gram_threads;

  const int my_groups = p.groups > static_cast<int>(blockIdx.x)
      ? (p.groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int tiles = my_groups * p.nch;

  auto prefetch = [&](int i) {
    const int g = blockIdx.x + (i / p.nch) * gridDim.x;
    const int c = i - (i / p.nch) * p.nch;
    const int w0 = c * p.nwc;
    const int site0 = g * p.sites;
    const int rows_act = min(p.sites, p.e - site0) * p.k;
    wt::load_tile(stage + (i & 1) * stage_floats,
                  x + static_cast<size_t>(site0) * p.k * p.n, rows_act,
                  min(p.nwc, p.nwin - w0), p.nwc, w0, p.n, p.lo, p.vec);
  };

  if (tiles > 0) prefetch(0);
  wt::cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    // tile i + 1 fills the stage tile i - 1 left while tile i lands
    if (i + 1 < tiles) prefetch(i + 1);
    wt::cp_async_commit();
    wt::cp_async_wait_one();
    __syncthreads();   // tile i has landed for every thread

    const int g = blockIdx.x + (i / p.nch) * gridDim.x;
    const int c = i - (i / p.nch) * p.nch;
    const int w0 = c * p.nwc;
    const int nw = min(p.nwc, p.nwin - w0);
    const int site0 = g * p.sites;
    const int sites = min(p.sites, p.e - site0);
    const int rows_act = sites * p.k;
    const float* tile = stage + (i & 1) * stage_floats;
    const bool last = c == p.nch - 1;

    if (tid >= gram_threads) {
      // power sums: one thread per (stream, window), left to right
      const int st = tid - gram_threads;
      for (int t = st; t < rows_act * nw; t += sum_threads) {
        const int r = t / nw;
        const int w = t - r * nw;
        const float4* win =
            reinterpret_cast<const float4*>(tile + (r * p.nwc + w) * kPitch);
        float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
        for (int q = 0; q < wt::kWin / 4; ++q) {
          const float4 v4 = win[q];
          const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = vs[j];
            const float v2 = __fmul_rn(v, v);
            s1 = __fadd_rn(s1, v);
            if (p.fma_sums) {
              s2 = __fmaf_rn(v, v, s2);
              s3 = __fmaf_rn(v2, v, s3);
              s4 = __fmaf_rn(v2, v2, s4);
            } else {
              s2 = __fadd_rn(s2, v2);
              s3 = __fadd_rn(s3, __fmul_rn(v2, v));
              s4 = __fadd_rn(s4, __fmul_rn(v2, v2));
            }
          }
        }
        part[wt::part_index(w, 0, r, 4, rows)] = s1;
        part[wt::part_index(w, 1, r, 4, rows)] = s2;
        part[wt::part_index(w, 2, r, 4, rows)] = s3;
        part[wt::part_index(w, 3, r, 4, rows)] = s4;
      }
      named_barrier(1, sum_threads);   // every window sum of the tile

      // the window sums in blocked_sum's order, carried across chunks
      for (int t = st; t < rows_act * 4; t += sum_threads) {
        const int m = t / rows_act;
        const int r = t - m * rows_act;
        float cur = c == 0 ? 0.f : cur_s[t];
        float tot = c == 0 ? 0.f : tot_s[t];
        int outer = wt::window_of_prev(w0, p.lo2);
#pragma unroll 8
        for (int w = 0; w < nw; ++w)
          wt::add_window_sum(cur, tot, outer, w0 + w, p.lo2,
                             part[wt::part_index(w, m, r, 4, rows)]);
        if (last) {
          mom[(static_cast<size_t>(site0) * p.k + r) * 4 + m] =
              __fadd_rn(tot, cur);
        } else {
          cur_s[t] = cur;
          tot_s[t] = tot;
        }
      }
    } else {
      gram_tile(tile, chains, p, sites, w0, nw, c, last, row_pitch, site0,
                xxt);
    }
    __syncthreads();   // every thread is done with tile i's stage
  }
}

}  // namespace

extern "C" int stream_stats_fleet(const float* x, float* mom, float* xxt,
                                  int e, int k, int n, int fused,
                                  void* stream) {
  if (e <= 0 || k <= 0 || n <= 0 || k > 64 || n > wt::kWin * wt::kWin * wt::kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const wt::Windows win = wt::windows_of(n);
  Params p;
  p.e = e;
  p.k = k;
  p.n = n;
  p.nwin = win.nwin;
  p.lo = win.lo;
  p.lo2 = win.lo2;
  // tiles of about kThreads (stream, window) pairs within one stage; a
  // site too large for a stage is cut into chunks of windows
  const int site_floats = k * win.nwin * kPitch;
  if (site_floats <= wt::kStageFloats) {
    p.nwc = win.nwin;
    int g = wt::kStageFloats / site_floats;
    g = std::min(g, 64 / k);
    g = std::min(g, std::max(1, kThreads / (k * win.nwin)));
    p.sites = std::max(1, std::min(g, e));
  } else {
    p.sites = 1;
    p.nwc = std::max(1, wt::kStageFloats / (k * kPitch));
  }
  p.nch = (win.nwin + p.nwc - 1) / p.nwc;
  p.groups = (e + p.sites - 1) / p.sites;
  p.npairs = k * (k + 1) / 2;
  p.m4 = n - n % 4;
  p.fma_sums = fused && win.nwin == 1;
  // k <= 8: the Gram block is about as much work as the power sums; a
  // larger k has k (k + 1) / 2 products per column to the power sums' 7
  p.gram_warps = k <= 8 ? kWarps / 2 : kWarps - 1;
  p.vec = n % 4 == 0 && p.lo % 4 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int rows = p.sites * k;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(rows) * p.nwc * kPitch +
       static_cast<size_t>(p.nwc) * (4 * rows + 1) + rows * 8 +
       static_cast<size_t>(p.sites) * p.npairs * 4);
  int grid = 0;
  cudaError_t err = wt::persistent_grid(stream_stats_fleet_kernel, smem,
                                        p.groups, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_stats_fleet_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(x, mom, xxt,
                                                                   p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stream_stats_fleet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
