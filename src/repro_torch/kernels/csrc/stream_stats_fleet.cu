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
// carried across chunks in shared memory.  Products and sums use the _rn
// intrinsics, which the compiler never contracts into FMAs, so the power
// sums are bitwise the plain version's: the statistics built on them cancel
// catastrophically, and a different rounding would move allocations.
//
// Gram block: the k rows are cut into blocks of 8, and each pair of row
// blocks (a <= b) is one item.  A Gram warp owns an item (or a share of its
// columns when a tile has fewer items than Gram warps); each lane reads one
// column's 8 + 8 values from shared memory once and accumulates the item's
// 64 products (36 on a diagonal block) in registers.  A butterfly across
// the warp's lanes (32 + 16 + 8 + 4 + 2 shuffles) leaves each lane two of
// the 64 sums, which it adds to the warp's own slot in shared memory; at
// the end of the group the slots of an item are added in a fixed order.
// No atomics: the result is the same on every run.  The Gram block agrees
// with the plain version's matmul to f32 rounding (it is not in
// blocked_sum's order); tensor cores are not used, since TF32 would not
// hold 2e-5.
#include <cuda_runtime.h>

#include <algorithm>

#include "window_tiles.cuh"

namespace {

using wt::kPitch;
using wt::kThreads;
using wt::kWarps;
constexpr int kKB = 8;            // rows per Gram row block
constexpr int kBlockPairs = kKB * kKB;

struct Params {
  int e, k, n, nwin, lo, lo2;
  int sites;      // G: sites per group
  int nwc, nch;   // windows per chunk, chunks per group
  int groups;
  int nb, nbp;    // row blocks of 8, pairs of them (a <= b)
  int gram_warps; // warps on the Gram block; the rest take the power sums
  int wpi;        // Gram warps per item (1: each warp loops over items)
  int vec;        // 16-byte copies
};

// row blocks (a, b), a <= b, of pair p in row-major upper-triangle order
__device__ __forceinline__ void block_pair(int p, int nb, int& a, int& b) {
  a = 0;
  while (p >= nb - a) {
    p -= nb - a;
    ++a;
  }
  b = a + p;
}

// one level of warp_butterfly: c values a lane, partner lane ^ (c / 4);
// the lane with that bit set keeps the upper half, the other the lower
template <int C>
__device__ __forceinline__ void butterfly_level(float (&v)[kBlockPairs],
                                                int lane) {
  const bool upper = lane & (C / 4);
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float send = upper ? v[i] : v[i + C / 2];
    const float keep = upper ? v[i + C / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, C / 4);
  }
}

// sum v[64] over the 32 lanes of a warp; lane l ends with the sums of
// entries 2l and 2l + 1 in v[0], v[1]
__device__ __forceinline__ void warp_butterfly(float (&v)[kBlockPairs]) {
  const int lane = threadIdx.x & 31;
  butterfly_level<64>(v, lane);
  butterfly_level<32>(v, lane);
  butterfly_level<16>(v, lane);
  butterfly_level<8>(v, lane);
  butterfly_level<4>(v, lane);
}

// products of rows row_a .. row_a + 7 and row_b .. row_b + 7 over the
// columns col0, col0 + step, ... of the tile; rows past k read as 0
template <bool kDiag>
__device__ __forceinline__ void gram_item(const float* tile, int row_a,
                                          int row_b, int na, int nb_rows,
                                          int row_pitch, int ncols, int col0,
                                          int step, float (&acc)[kBlockPairs]) {
#pragma unroll
  for (int i = 0; i < kBlockPairs; ++i) acc[i] = 0.f;
  for (int col = col0; col < ncols; col += step) {
    const float* p = tile + (col >> 5) * kPitch + (col & 31);
    float va[kKB], vb[kKB];
#pragma unroll
    for (int i = 0; i < kKB; ++i) {
      va[i] = i < na ? p[(row_a + i) * row_pitch] : 0.f;
      vb[i] = kDiag ? va[i] : (i < nb_rows ? p[(row_b + i) * row_pitch] : 0.f);
    }
#pragma unroll
    for (int i = 0; i < kKB; ++i)
#pragma unroll
      for (int j = kDiag ? i : 0; j < kKB; ++j)
        acc[i * kKB + j] = fmaf(va[i], vb[j], acc[i * kKB + j]);
  }
}

// wait at barrier ``id`` (1..15) for the ``count`` threads of some warps
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The Gram warps' share of a tile: their items' products added to their
// slots, and at the end of a group each site's block written from them.
__device__ __forceinline__ void gram_tile(const float* tile, float* slot,
                                          const Params p, int items,
                                          int sites, int nw, int c, bool last,
                                          int row_pitch, int site0,
                                          float* __restrict__ xxt) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gram_threads = p.gram_warps * 32;
  const int first = p.wpi > 1 ? warp / p.wpi : warp;
  const int split = p.wpi > 1 ? warp - first * p.wpi : 0;
  // one item a warp if wpi > 1, else every gram_warps-th
  const int stride = p.wpi > 1 ? items : p.gram_warps;
  for (int it = first; it < items; it += stride) {
    const int gs = it / p.nbp;
    if (gs >= sites) break;
    int a, b;
    block_pair(it - gs * p.nbp, p.nb, a, b);
    const int na = min(kKB, p.k - a * kKB);
    const int nbr = min(kKB, p.k - b * kKB);
    const float* base = tile + gs * p.k * row_pitch;
    float acc[kBlockPairs];
    if (a == b) {
      gram_item<true>(base, a * kKB, a * kKB, na, na, row_pitch, nw * 32,
                      split * 32 + lane, p.wpi * 32, acc);
    } else {
      gram_item<false>(base, a * kKB, b * kKB, na, nbr, row_pitch, nw * 32,
                       split * 32 + lane, p.wpi * 32, acc);
    }
    warp_butterfly(acc);
    float* sl = slot + (it * p.wpi + split) * kBlockPairs + 2 * lane;
    sl[0] = c == 0 ? acc[0] : sl[0] + acc[0];
    sl[1] = c == 0 ? acc[1] : sl[1] + acc[1];
  }
  if (!last) return;
  named_barrier(2, gram_threads);   // every slot of the group

  // each site's Gram block from its items' slots, added in slot order
  const int kk = p.k * p.k;
  for (int t = tid; t < sites * kk; t += gram_threads) {
    const int gs = t / kk;
    const int ij = t - gs * kk;
    const int i0 = ij / p.k;
    const int j0 = ij - i0 * p.k;
    const int lo_ = min(i0, j0);
    const int hi_ = max(i0, j0);
    const int a = lo_ / kKB;
    const int b = hi_ / kKB;
    const int item = gs * p.nbp + a * p.nb - a * (a - 1) / 2 + (b - a);
    const float* sl = slot + item * p.wpi * kBlockPairs +
                      (lo_ - a * kKB) * kKB + (hi_ - b * kKB);
    float v = sl[0];
    for (int s2 = 1; s2 < p.wpi; ++s2) v += sl[s2 * kBlockPairs];
    xxt[static_cast<size_t>(site0) * kk + t] = v;
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
  float* slot = tot_s + rows * 4;              // (items x wpi, 64) Gram
  const int tid = threadIdx.x;
  const int items = p.sites * p.nbp;
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
            s2 = __fadd_rn(s2, v2);
            s3 = __fadd_rn(s3, __fmul_rn(v2, v));
            s4 = __fadd_rn(s4, __fmul_rn(v2, v2));
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
      gram_tile(tile, slot, p, items, sites, nw, c, last, row_pitch, site0,
                xxt);
    }
    __syncthreads();   // every thread is done with tile i's stage
  }
}

}  // namespace

extern "C" int stream_stats_fleet(const float* x, float* mom, float* xxt,
                                  int e, int k, int n, void* stream) {
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
  p.nb = (k + kKB - 1) / kKB;
  p.nbp = p.nb * (p.nb + 1) / 2;
  const int items = p.sites * p.nbp;
  // k <= 8: one 8 x 8 item per site, as much work as the power sums; a
  // larger k has k^2 / 2 products per column to the power sums' 7
  p.gram_warps = p.nbp == 1 ? kWarps / 2 : kWarps - 1;
  p.wpi = items >= p.gram_warps ? 1 : p.gram_warps / items;
  p.vec = n % 4 == 0 && p.lo % 4 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int rows = p.sites * k;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(rows) * p.nwc * kPitch +
       static_cast<size_t>(p.nwc) * (4 * rows + 1) + rows * 8 +
       static_cast<size_t>(items) * p.wpi * kBlockPairs);
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
