// Power sums and the full Gram matrix of one window, in one deterministic
// launch.
//
// Replaces the TPU kernel src/repro/kernels/stream_stats/kernel.py::
// stream_stats_pallas (body _kernel).  For x of shape (k, N), f32 or bf16
// (accumulated in f32), contiguous, it writes
//   mom (k, 4): S_m = sum_t x^m, m = 1..4, per stream;
//   xxt (k, k): X X^T, the whole Gram matrix, exactly symmetric.
//
// What bounds it: each element of x is read once and feeds k + 1 Gram flops
// (the upper triangle) and 7 power-sum flops.  At k = 64 that is 4 bytes
// against 72 f32 flops: 1.2 ns of HBM per column against 1.1 ns of FFMA
// at the card's peak, so memory and the FFMA units bound it about equally
// (at N = 262144, 0.0200 ms against 0.0180 ms).  At the small windows of
// benchmarks/kernel_bench.py both are below the cost of one launch and one
// grid-wide barrier, which set the least time there.
//
// Design.  The TPU kernel walks a sequential (k/8, k/8, N/tn) grid and
// carries each output tile in VMEM along N.  Here one persistent,
// cooperative grid (as many blocks as fit on the card at once, at most one
// per work item) splits N instead.
//
// Work items.  The rows are cut into tiles of T (the smallest power of two
// >= k in [8, 64]; 64 when k > 64).  A unit is a diagonal tile (its upper
// triangle) or one half of an off-diagonal tile pair ti < tj (32 rows of
// tile ti against the 64 of tile tj), so k > 64 has ntiles^2 units.  A work
// item is a unit and a contiguous run of tps column tiles of tn columns
// (the host's plan fixes tn, tps and the grid from k, N and the number of
// co-resident blocks); block b takes items b, b + grid, ...
//
// Staging.  A column tile of the unit's rows goes into shared memory by
// cp.async, row-major, zero past k and N, through a two-stage ring: tile
// i + 1 lands while tile i is computed.  The rows' pitch is a constant of
// T (the widest tile: 8192 / T elements, 256 at T = 64; 16 bytes more at
// T = 8), so that every read's row offset is an immediate.  Copies are 16
// bytes where rows and x are 16-byte aligned (f32: N % 4 == 0; bf16:
// N % 8 == 0), else 4 bytes (f32) or plain 2-byte loads (bf16).
//
// Gram.  The unit's rows are cut into blocks of 8; each pair of row blocks
// (a <= b) is owned by L threads (8 at T = 64; 16 at T = 32; a warp at
// T = 16), which take the tile's quads of 4 columns in turn, read the 8 + 8
// rows' quads (one 128-bit read a row for f32, 64-bit for bf16, widened to
// f32 on the read; the 8 threads of a quarter-warp read one row's 32
// consecutive columns) and accumulate the 8 x 8 products in registers
// with FFMA.  A diagonal pair keeps only j >= i.  The power sums of a
// diagonal block's rows come from the same registers, S2 as the Gram's
// diagonal, except at T = 64, where one warp takes S1, S3 and S4 of all
// 64 rows, so that the ten warps' work splits evenly over the four
// schedulers.  The diagonal pairs come first and fill whole warps.  At
// T = 8 (one pair) each thread takes one output instead: one of the 36
// Gram entries i <= j, or S1, S3 and S4 of one row, over every seventh
// quad of the tile (seven phases); the phases' sums are added in order
// through shared memory, with no butterfly.  There a quarter-warp reads
// one quad of eight rows, which the 16 bytes of padding put on distinct
// banks.  The host cuts small windows into blocks of 2 KB of x: there the
// first tile's latency, the barrier and the final sum set the time, and
// each column a block adds lengthens it.
//
// Reduction.  At the end of an item the L threads of a pair add their
// registers by a butterfly of shuffles (at T = 8 the phases add theirs
// through shared memory) and write the sums straight to the item's slot
// of the workspace: 64 floats for each of the unit's row-block pairs and
// its rows' power sums.  One grid-wide barrier (cooperative
// groups) follows; then each block takes fixed groups of 32 slot entries:
// warp w adds an entry over splits [w S / 10, (w + 1) S / 10) in split
// order, the ten runs are added in warp order, and the sum goes to both
// triangles; a grid of one block needs no barrier.  Every sum runs in an
// order fixed by (k, N, grid), and no float atomics are used, so two
// launches give bitwise equal results.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// at T = 64: 36 row-block pairs x 8 threads and a warp for the power sums,
// ten warps, so that each of the SM's four schedulers issues for two or
// three of them and the lighter diagonal warps share the three-warp ones
constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kWide = 64;         // tile edge when k > 64

// Elements between staged rows: the widest column tile at tile edge T, a
// constant, so that every shared-memory read takes its row offset as an
// immediate.  8192 / T below T = 64; 256 at T = 64, where the FFMA loop,
// not the copies, sets the pace, and wider tiles halve the tile barriers.
__host__ __device__ constexpr int tile_cols(int tile) {
  return tile == kWide ? 256 : 8192 / tile;
}

// Elements between staged rows: the widest column tile, and at T = 8,
// where a quarter-warp reads one column quad of eight rows (kOutput
// below), 16 bytes more, which put those rows on distinct banks.
template <int T, typename In>
__host__ __device__ constexpr int row_pitch() {
  return tile_cols(T) + (T == 8 ? 16 / static_cast<int>(sizeof(In)) : 0);
}

// elements of one ring stage: T rows, or at T = 64 the 96 rows of half an
// off-diagonal tile pair
template <int T, typename In>
__host__ __device__ constexpr int stage_elems() {
  return (T == kWide ? 32 + kWide : T) * row_pitch<T, In>();
}

struct Params {
  int k, n;
  int ntiles;    // row tiles (1 when k <= 64)
  int zslot;     // floats of one item's workspace slot
  int units, splits, tps, items, ncol;
  int tn_log2;   // columns of a column tile, log2
  int vec;       // 16-byte copies
};

// a unit: its staged rows are rows_a rows from row_a, then (off-diagonal
// units) 64 rows from row_b
struct Unit {
  bool diag;
  int row_a, rows_a, row_b;
};

__device__ __forceinline__ Unit unit_of(int u, const Params& p, int tile) {
  Unit un;
  if (u < p.ntiles) {
    un.diag = true;
    un.row_a = un.row_b = u * kWide;
    un.rows_a = tile;
    return un;
  }
  // the off-diagonal pairs ti < tj in row-major order, two halves each
  int q = (u - p.ntiles) >> 1;
  int ti = 0;
  while (q >= p.ntiles - 1 - ti) {
    q -= p.ntiles - 1 - ti;
    ++ti;
  }
  un.diag = false;
  un.row_a = ti * kWide + ((u - p.ntiles) & 1) * 32;
  un.rows_a = 32;
  un.row_b = (ti + 1 + q) * kWide;
  return un;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// one element past the 16-byte path
__device__ __forceinline__ void copy_one(float* d, const float* s) {
  cp_async4(d, s);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* d,
                                         const __nv_bfloat16* s) {
  *reinterpret_cast<unsigned short*>(d) =
      *reinterpret_cast<const unsigned short*>(s);
}

__device__ __forceinline__ void zero_one(float* d) { *d = 0.f; }
__device__ __forceinline__ void zero_one(__nv_bfloat16* d) {
  *reinterpret_cast<unsigned short*>(d) = 0;
}

// four consecutive elements of a staged row, as f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// Start the copies of column tile t of the unit's rows into dst.  Every
// thread of the block calls it; the copies complete with its next commit
// group.
template <int kPitch, typename In>
__device__ __forceinline__ void stage_tile(In* dst, const In* __restrict__ x,
                                           const Params& p, const Unit& un,
                                           int rows, int t) {
  const int c0 = t << p.tn_log2;
  const int tn = 1 << p.tn_log2;
  if (p.vec) {
    constexpr int kPer = 16 / sizeof(In);               // elements a copy
    constexpr int kPerLog2 = sizeof(In) == 4 ? 2 : 3;
    const int cpr_log2 = p.tn_log2 - kPerLog2;          // copies a row
    for (int id = threadIdx.x; id < rows << cpr_log2; id += kThreads) {
      const int sr = id >> cpr_log2;
      const int c = (id & ((1 << cpr_log2) - 1)) * kPer;
      const int gr = sr < un.rows_a ? un.row_a + sr
                                    : un.row_b + sr - un.rows_a;
      In* d = dst + sr * kPitch + c;
      if (gr < p.k && c0 + c < p.n) {
        cp_async16(d, x + static_cast<size_t>(gr) * p.n + c0 + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int id = threadIdx.x; id < rows << p.tn_log2; id += kThreads) {
      const int sr = id >> p.tn_log2;
      const int c = id & (tn - 1);
      const int gr = sr < un.rows_a ? un.row_a + sr
                                    : un.row_b + sr - un.rows_a;
      In* d = dst + sr * kPitch + c;
      if (gr < p.k && c0 + c < p.n) {
        copy_one(d, x + static_cast<size_t>(gr) * p.n + c0 + c);
      } else {
        zero_one(d);
      }
    }
  }
}

// One level of a butterfly over C of a thread's values: partner lane ^ M;
// the lane with bit M keeps the upper half, the other the lower.
template <int C, int M, int N>
__device__ __forceinline__ void butterfly_level(float (&v)[N], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float send = upper ? v[i] : v[i + C / 2];
    const float keep = upper ? v[i + C / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Sum v[N] over the 2M lanes of an aligned group (levels M, M / 2, .., 1):
// lane l of the group ends with the sums of entries [l C / 2M, (l + 1)
// C / 2M) in v[0 .. C / 2M).
template <int M, int C, int N>
__device__ __forceinline__ void butterfly(float (&v)[N], int lane) {
  if constexpr (M > 0) {
    butterfly_level<C, M>(v, lane);
    butterfly<M / 2, C / 2>(v, lane);
  }
}

// threads that own a row-block pair: 8 for T = 64 (36 pairs), 16 for
// T = 32 (10 pairs), 32 below (one warp a pair)
template <int T>
__host__ __device__ constexpr int lanes() {
  return T == 64 ? 8 : T == 32 ? 16 : 32;
}

// What a thread computes in the column loop: the 8 x 8 products of an
// off-diagonal pair of row blocks; the upper triangle of a diagonal block
// with (kDiagPow) or without (kDiagPair) its rows' power sums S1..S4;
// (kPowers, one warp at T = 64) S1, S3, S4 of every fourth row; or, at
// T = 8, one output: the Gram entry of rows ra <= rb, or (rb < 0) S1, S3
// and S4 of row ra (kOutput).
enum Role { kOffPair, kDiagPow, kDiagPair, kPowers, kOutput };

// One work item: the column loop over the thread's quads q0, q0 + qstep,
// ... of each column tile, then the butterfly over the threads that share
// its sums.  A pair thread owns rows ra .. ra + 7 and rb .. rb + 7 of the
// staged tile; the power warp's lane owns rows rep / 8 + 4 j (j = 0..15).
// Threads with no work (active false) take part in the copies, the
// barriers and the butterfly with zeros.
template <typename In, Role kRole, int L, int kPitch, int kStage>
__device__ __forceinline__ void run_item(
    In* stage, const In* __restrict__ x, const Params& p, const Unit& un,
    int rows, int t0, int nt, bool active, int ra, int rb, int rep, int q0,
    int qstep, float (&acc)[64], float (&pw)[48]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 48; ++i) pw[i] = 0.f;
  const int quads = 1 << (p.tn_log2 - 2);
  stage_tile<kPitch>(stage, x, p, un, rows, t0);
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    // tile i + 1 fills the stage tile i - 1 left while tile i lands
    if (i + 1 < nt) stage_tile<kPitch>(stage + ((i + 1) & 1) * kStage, x, p,
                                       un, rows, t0 + i + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // tile i has landed for every thread
    const In* tile = stage + (i & 1) * kStage;
    for (int q = active ? q0 : quads; q < quads; q += qstep) {
      const In* col = tile + 4 * q;
      if (kRole == kOutput) {
        float v[4];
        load4(col + ra * kPitch, v);
        if (rb >= 0) {
          float w[4];
          load4(col + rb * kPitch, w);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[0] = fmaf(v[c], w[c], acc[0]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v2 = v[c] * v[c];
            pw[0] += v[c];
            pw[1] = fmaf(v2, v[c], pw[1]);
            pw[2] = fmaf(v2, v2, pw[2]);
          }
        }
        continue;
      }
      if (kRole == kPowers) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float v[4];
          load4(col + ((rep >> 3) + 4 * j) * kPitch, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v2 = v[c] * v[c];
            pw[3 * j] += v[c];
            pw[3 * j + 1] = fmaf(v2, v[c], pw[3 * j + 1]);
            pw[3 * j + 2] = fmaf(v2, v2, pw[3 * j + 2]);
          }
        }
        continue;
      }
      float a[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) load4(col + (ra + r) * kPitch, a[r]);
      if (kRole == kDiagPow) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = a[r][c];
            const float v2 = v * v;
            pw[4 * r] += v;
            pw[4 * r + 1] = fmaf(v, v, pw[4 * r + 1]);
            pw[4 * r + 2] = fmaf(v2, v, pw[4 * r + 2]);
            pw[4 * r + 3] = fmaf(v2, v2, pw[4 * r + 3]);
          }
      }
      if (kRole != kOffPair) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = r; s < 8; ++s)
              acc[r * 8 + s] = fmaf(a[r][c], a[s][c], acc[r * 8 + s]);
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          float b[4];
          load4(col + (rb + s) * kPitch, b);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < 8; ++r)
              acc[r * 8 + s] = fmaf(a[r][c], b[c], acc[r * 8 + s]);
        }
      }
    }
    __syncthreads();   // every thread is done with tile i's stage
  }
  const int lane = threadIdx.x & 31;
  if (kRole == kPowers) {
    butterfly<4, 48>(pw, lane);
  } else if (kRole != kOutput) {
    butterfly<L / 2, 64>(acc, lane);
    if (kRole == kDiagPow) butterfly<L / 2, 32>(pw, lane);
  }
}

// n consecutive floats of v to dst, aligned to n floats
template <int N>
__device__ __forceinline__ void store(float* dst, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

// row-block pair p of a diagonal unit with nb blocks: the diagonal pairs
// first, then a < b row-major
__device__ __forceinline__ void diag_pair(int p, int nb, int& a, int& b) {
  if (p < nb) {
    a = b = p;
    return;
  }
  int q = p - nb;
  a = 0;
  while (q >= nb - 1 - a) {
    q -= nb - 1 - a;
    ++a;
  }
  b = a + 1 + q;
}

// The output of entry e of a unit's slot (P row-block pairs, nb diagonal
// blocks): the Gram entry (row, col), or the power sum m of row; false
// for the lower half of a diagonal block and for rows or columns past k.
__device__ __forceinline__ bool slot_entry(int e, const Unit& un, int P,
                                           int nb, int k, int& row,
                                           int& col, int& m) {
  col = 0;
  m = -1;
  if (e < P * 64) {
    int a, b;
    if (un.diag) {
      diag_pair(e >> 6, nb, a, b);
    } else {
      a = (e >> 9) & 7;
      b = (e >> 6) & 7;
    }
    const int i = 8 * a + ((e >> 3) & 7);
    const int j = 8 * b + (e & 7);
    row = un.row_a + i;
    col = (un.diag ? un.row_a : un.row_b) + j;
    if (un.diag && i > j) return false;
  } else {
    const int f = e - P * 64;
    row = un.row_a + (f >> 2);
    m = f & 3;
  }
  return row < k && col < k;
}

__device__ __forceinline__ void write_output(float v, int row, int col, int m,
                                             int k, float* __restrict__ mom,
                                             float* __restrict__ xxt) {
  if (m >= 0) {
    mom[row * 4 + m] = v;
  } else {
    xxt[static_cast<size_t>(row) * k + col] = v;
    xxt[static_cast<size_t>(col) * k + row] = v;
  }
}

template <typename In, int T>
__global__ void __launch_bounds__(kThreads, 1)
stream_stats_window(const In* __restrict__ x, float* __restrict__ mom,
                    float* __restrict__ xxt, float* __restrict__ ws,
                    const Params p) {
  constexpr int L = lanes<T>();
  constexpr int kGram = 64 / L;   // Gram sums a thread ends with
  constexpr int kPow = 32 / L;    // power sums a diagonal thread ends with
  constexpr int nb = T / 8;
  constexpr int kDiagPairs = nb * (nb + 1) / 2;
  constexpr bool kPowWarp = T == kWide;
  constexpr int kPitch = row_pitch<T, In>();
  constexpr int kStage = stage_elems<T, In>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* stage = reinterpret_cast<In*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int u = it / p.splits;
    const int s = it - u * p.splits;
    const Unit un = unit_of(u, p, T);
    // The thread's work.  A diagonal unit has nb(nb + 1) / 2 row-block
    // pairs, the nb diagonal ones first; its threads are the diagonal
    // pairs' (L each), at T = 64 one warp for the power sums, then the
    // other pairs'.  Half an off-diagonal tile pair has 4 x 8 pairs.
    const int P = un.diag ? kDiagPairs : 32;
    const int ndiag = un.diag ? nb * L : 0;
    const int npow = un.diag && kPowWarp ? 32 : 0;
    const bool dthread = tid < ndiag;
    const bool pthread = !dthread && tid < ndiag + npow;
    const int pair = dthread ? tid / L
        : (un.diag ? nb : 0) + (tid - ndiag - npow) / L;
    const int rep = tid % L;
    const bool active = dthread || pthread || pair < P;
    int a = 0, b = 0;
    if (!un.diag) {
      a = pair >> 3;
      b = pair & 7;
    } else if (active && !pthread) {
      diag_pair(pair, nb, a, b);
    }
    // staged rows of the pair's blocks; an off-diagonal unit stages its 32
    // rows of tile ti first
    const int ra = 8 * a;
    const int rb = un.diag ? 8 * b : 32 + 8 * b;
    const int rows = un.diag ? T : 32 + kWide;
    const int t0 = s * p.tps;
    const int nt = min(t0 + p.tps, p.ncol) - t0;
    // The item's sums in slot order: each pair's 8 x 8 block (row-major),
    // then the power sums, S1..S4 of row R at 64 P + 4 R, straight to the
    // item's slot of the workspace.
    float* img = ws + static_cast<size_t>(it) * p.zslot;
    float* pows = img + P * 64;
    float acc[64], pw[48];
    if constexpr (T == 8) {
      // One row-block pair: register blocks would leave it to one warp
      // and a butterfly over 32 lanes.  Instead each thread takes one of
      // the 36 Gram entries i <= j or one row's S1, S3, S4 over every
      // kPhases-th quad of each column tile; the phases' sums meet in
      // shared memory and are added in phase order.
      constexpr int kPhases = 7;   // 36 x 7 Gram threads below 256
      const bool gram = tid < 36 * kPhases;
      const bool row_sums = tid >= 256 && tid < 256 + 8 * kPhases;
      const int o = gram ? tid % 36 : (tid - 256) & 7;
      const int ph = gram ? tid / 36 : (tid - 256) >> 3;
      int i = o, j = -1;
      if (gram) {
        i = 0;
        j = o;
        while (j >= 8 - i) {
          j -= 8 - i;
          ++i;
        }
        j += i;
      }
      run_item<In, kOutput, 1, kPitch, kStage>(
          stage, x, p, un, rows, t0, nt, gram || row_sums, i, j, 0, ph,
          kPhases, acc, pw);
      // run_item's last barrier has freed the stages
      float* part = reinterpret_cast<float*>(smem_raw);   // (kPhases, 96)
      float* im = part + ph * 96;
      if (gram) {
        im[i * 8 + j] = acc[0];
        if (i == j) im[64 + 4 * i + 1] = acc[0];   // S2
      } else if (row_sums) {
        im[64 + 4 * i] = pw[0];
        im[64 + 4 * i + 2] = pw[1];
        im[64 + 4 * i + 3] = pw[2];
      }
      __syncthreads();
      if (tid < 96 && (tid >= 64 || (tid >> 3) <= (tid & 7))) {
        float v = part[tid];
        for (int q = 1; q < kPhases; ++q) v += part[q * 96 + tid];
        img[tid] = v;
      }
      __syncthreads();   // the images are read before the next copies
      continue;
    }
    // warp-uniform: each kind of thread fills whole warps
    if (pthread) {
      run_item<In, kPowers, 8, kPitch, kStage>(
          stage, x, p, un, rows, t0, nt, true, 0, 0, lane, lane & 7, 8, acc,
          pw);
      // row slots 2 l and 2 l + 1 of lane l of the warp's row group h,
      // whose rows are h + 4 j
      const int l = lane & 7;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (lane >> 3) + 4 * (2 * l + h);
        pows[4 * row] = pw[3 * h];
        pows[4 * row + 2] = pw[3 * h + 1];
        pows[4 * row + 3] = pw[3 * h + 2];
      }
    } else if (dthread && kPowWarp) {
      run_item<In, kDiagPair, L, kPitch, kStage>(
          stage, x, p, un, rows, t0, nt, true, ra, rb, rep, rep, L, acc, pw);
      store<kGram>(img + pair * 64 + rep * kGram, acc);
      // S2 of row rep of the block is the Gram's diagonal entry
      float d2 = acc[0];
#pragma unroll
      for (int j = 1; j < 8; ++j)
        if (j == rep) d2 = acc[j];
      pows[4 * (ra + rep) + 1] = d2;
    } else if (dthread) {
      run_item<In, kDiagPow, L, kPitch, kStage>(
          stage, x, p, un, rows, t0, nt, true, ra, rb, rep, rep, L, acc, pw);
      store<kGram>(img + pair * 64 + rep * kGram, acc);
      store<kPow>(pows + pair * 32 + rep * kPow, pw);
    } else {
      run_item<In, kOffPair, L, kPitch, kStage>(
          stage, x, p, un, rows, t0, nt, active, ra, rb, rep, rep, L, acc,
          pw);
      if (active) store<kGram>(img + pair * 64 + rep * kGram, acc);
    }
  }

  // every slot is written before any is read
  if (gridDim.x > 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }

  // Groups of 32 consecutive entries of a unit's slots: warp w adds the
  // entry over splits [w S / 10, (w + 1) S / 10) in split order (sixteen
  // splits' loads in flight at once), the ten runs are added in warp
  // order, and the sum goes to its output and, off the diagonal, to the
  // mirror.
  const int warp = tid >> 5;
  const int s_lo = warp * p.splits / kWarps;
  const int s_hi = (warp + 1) * p.splits / kWarps;
  const int per_unit = p.zslot >> 5;
  float* part = reinterpret_cast<float*>(smem_raw);   // (kWarps, 32)
  for (int g = blockIdx.x; g < p.units * per_unit; g += gridDim.x) {
    const int u = g / per_unit;
    const int r = g - u * per_unit;
    const Unit un = unit_of(u, p, T);
    const int P = un.diag ? kDiagPairs : 32;
    if (r >= (un.diag ? p.zslot : 64 * P) >> 5) continue;   // uniform
    int e = (r << 5) + lane;
    int row, col, m;
    if (!slot_entry(e, un, P, nb, p.k, row, col, m)) e = -1;
    float v = 0.f;
    if (e >= 0) {
      const float* src = ws + static_cast<size_t>(u) * p.splits * p.zslot + e;
      for (int s0 = s_lo; s0 < s_hi; s0 += 16) {
        // sixteen loads, none behind a branch (past the run's end they
        // repeat its last split), so that all are in flight at once
        float t[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          t[q] = __ldcg(src + static_cast<size_t>(min(s0 + q, s_hi - 1)) *
                                  p.zslot);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (s0 + q < s_hi) v += t[q];
      }
    }
    part[warp * 32 + lane] = v;
    __syncthreads();
    if (warp == 0 && e >= 0) {
      float tot = part[lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tot += part[w * 32 + lane];
      write_output(tot, row, col, m, p.k, mom, xxt);
    }
    __syncthreads();
  }
}

// floats of out before the workspace: mom, xxt, and up to 32 bytes of
// padding
size_t workspace_offset(int k) {
  return (4 * static_cast<size_t>(k) + static_cast<size_t>(k) * k + 7) / 8 * 8;
}

template <typename In, int T>
constexpr size_t smem_bytes() {
  return 2 * stage_elems<T, In>() * sizeof(In);
}

// Dynamic shared memory above 48 KB needs the attribute on every device,
// before both the occupancy query and the launch.
template <typename In, int T>
cudaError_t prepare() {
  if (smem_bytes<In, T>() <= 48 * 1024) return cudaSuccess;
  static unsigned long long ready = 0;   // devices with the attribute set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(stream_stats_window<In, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<In, T>()));
  if (err == cudaSuccess) ready |= bit;
  return err;
}

template <typename In, int T>
cudaError_t blocks_per_sm(int* blocks) {
  cudaError_t err = prepare<In, T>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stream_stats_window<In, T>, kThreads, smem_bytes<In, T>());
}

template <typename In, int T>
cudaError_t launch(const void* xv, float* out, Params p, int grid,
                   cudaStream_t stream) {
  cudaError_t err = prepare<In, T>();
  if (err != cudaSuccess) return err;
  const In* x = static_cast<const In*>(xv);
  float* mom = out;
  float* xxt = out + 4 * p.k;
  float* ws = out + workspace_offset(p.k);
  void* args[] = {&x, &mom, &xxt, &ws, &p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stream_stats_window<In, T>), dim3(grid),
      dim3(kThreads), args, smem_bytes<In, T>(), stream);
}

template <typename In>
cudaError_t dispatch(int tile, const void* x, float* out, const Params& p,
                     int grid, cudaStream_t stream) {
  switch (tile) {
    case 8: return launch<In, 8>(x, out, p, grid, stream);
    case 16: return launch<In, 16>(x, out, p, grid, stream);
    case 32: return launch<In, 32>(x, out, p, grid, stream);
    default: return launch<In, 64>(x, out, p, grid, stream);
  }
}

template <typename In>
cudaError_t occupancy(int tile, int* blocks) {
  switch (tile) {
    case 8: return blocks_per_sm<In, 8>(blocks);
    case 16: return blocks_per_sm<In, 16>(blocks);
    case 32: return blocks_per_sm<In, 32>(blocks);
    default: return blocks_per_sm<In, 64>(blocks);
  }
}

bool valid_tile(int tile) {
  return tile == 8 || tile == 16 || tile == 32 || tile == 64;
}

}  // namespace

// Blocks of the tile-T kernel for ``dtype`` (0 = float32, 1 = bfloat16)
// that fit on one SM of the current device at once.
extern "C" int stream_stats_blocks_per_sm(int tile, int dtype, int* blocks) {
  if (!valid_tile(tile) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 0 ? occupancy<float>(tile, blocks)
                                     : occupancy<__nv_bfloat16>(tile, blocks));
}

// One launch for x (k, n) of ``dtype`` (0 = float32, 1 = bfloat16).  out
// holds mom (k, 4), then xxt (k, k), then, from the next multiple of 8
// floats, the workspace: splits slots of zslot floats for each of the
// ntiles^2 units (the tile's nb(nb + 1) / 2 row-block pairs of 64 floats
// and nb x 32 power sums, nb = tile / 8: 2560 floats at tile 64).  The plan (tile, tn_log2, splits, tps, grid)
// comes from the wrapper; grid must not exceed the co-resident blocks.
extern "C" int stream_stats(const void* x, int dtype, float* out, int k,
                            int n, int tile, int tn_log2, int splits, int tps,
                            int grid, void* stream) {
  const int ntiles = k > kWide ? (k + kWide - 1) / kWide : 1;
  if (k <= 0 || n <= 0 || (dtype != 0 && dtype != 1) || !valid_tile(tile) ||
      (ntiles > 1 && tile != kWide) || (ntiles == 1 && tile < k) ||
      tn_log2 < 6 || (1 << tn_log2) > tile_cols(tile) || splits < 1 ||
      tps < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.k = k;
  p.n = n;
  p.ntiles = ntiles;
  const int nb = tile / 8;
  p.zslot = 32 * nb * (nb + 1) + 32 * nb;
  p.units = ntiles * ntiles;
  p.splits = splits;
  p.tps = tps;
  p.items = p.units * splits;
  p.ncol = (n + (1 << tn_log2) - 1) >> tn_log2;
  p.tn_log2 = tn_log2;
  const int per = dtype == 0 ? 4 : 8;   // elements of a 16-byte copy
  p.vec = n % per == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if ((splits - 1) * tps >= p.ncol || splits * tps < p.ncol)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
      ? dispatch<float>(tile, x, out, p, grid, s)
      : dispatch<__nv_bfloat16>(tile, x, out, p, grid, s);
  return static_cast<int>(err);
}

extern "C" const char* stream_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
