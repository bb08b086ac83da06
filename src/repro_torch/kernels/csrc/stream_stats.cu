// Power sums and the full Gram matrix of one window, deterministically.
//
// Replaces the TPU kernel src/repro/kernels/stream_stats/kernel.py::
// stream_stats_pallas (body _kernel).  For x of shape (k, N), f32 or bf16
// (read as f32), contiguous, it writes
//   mom (k, 4): S_m = sum_t x^m, m = 1..4, per stream;
//   xxt (k, k): X X^T, the whole Gram matrix.
//
// What bounds it: each element of x is read once and feeds k + 1 Gram
// flops (the upper triangle) plus 7 power-sum flops.  At k = 64, N = 16384
// that is 4.2 MB in, 1.26 us of HBM, against 75 MFLOP, 1.1 us of f32 FMA
// at the card's peak: the two bounds are close, and memory sets the least
// time.  This kernel computes both triangles (134 MFLOP, 2.0 us at peak),
// so its own arithmetic, not memory, is its floor for k >= ~40.
//
// Design.  The TPU kernel walks a sequential (k/8, k/8, N/tn) grid and
// carries each output tile in VMEM along the N axis.  Hopper's blocks run
// in no order, so N is split instead: pass 1 gives each (column split,
// output tile) pair one block, which stages (T, TN) tiles of the rows of
// its output tile in shared memory as f32 (zero-padded past k and N) and
// accumulates a T x T Gram tile in registers, 4 x 4 per thread; the blocks
// of the first tile column also take the power sums of their rows.  Each
// block writes its partial sums to a workspace; pass 2 adds the splits of
// every output in split order.  Every sum runs in a fixed order and no
// float atomics are used, so two launches give bitwise equal results.
//
// T, the output tile edge, is the smallest power of two >= k in [4, 64];
// when T < 64 the 256 threads form R = 4096 / T^2 replicas of the T x T
// tile, each taking every R-th column, and the replicas are added in order
// at the end of the block.  k > 64 uses a grid of 64 x 64 tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 264;   // two blocks for each of the 132 SMs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// columns of a staged tile: 4096 floats, at most 256 columns
__host__ __device__ constexpr int tile_cols(int t) {
  return 4096 / t < 256 ? 4096 / t : 256;
}

template <int T>
struct Tiling {
  static constexpr int TN = tile_cols(T);
  static constexpr int LD = T + 4;         // staged row stride, float4-aligned
  static constexpr int G = T / 4;          // 4 x 4 micro-tiles per side
  static constexpr int R = kThreads / (G * G);   // replicas of the tile
  static constexpr int MS = kThreads / T;  // power-sum threads per row
  static constexpr int kRed = (R * T * T > 2 * TN * LD) ? R * T * T
                                                         : 2 * TN * LD;
  static constexpr int kSmemFloats = kRed + MS * T * 4;
};

template <typename In, int T>
__device__ void stage(float* dst, const In* __restrict__ x, int row0, int c0,
                      int k, int n) {
  using Tl = Tiling<T>;
  for (int e = threadIdx.x; e < T * Tl::TN; e += kThreads) {
    const int r = e / Tl::TN;
    const int c = e - r * Tl::TN;
    const int gr = row0 + r;
    const int gc = c0 + c;
    dst[c * Tl::LD + r] = (gr < k && gc < n)
        ? to_f32(x[static_cast<size_t>(gr) * n + gc]) : 0.f;
  }
}

// grid (splits, ntiles * ntiles); block (ti, tj) of split s covers column
// tiles [s * tps, (s + 1) * tps)
template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
stream_stats_partial(const In* __restrict__ x, float* __restrict__ gpart,
                     float* __restrict__ mpart, int k, int n, int ntiles,
                     int tps) {
  using Tl = Tiling<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem;                       // (TN, LD) rows of tile ti
  float* b_s = smem + Tl::TN * Tl::LD;     // (TN, LD) rows of tile tj
  float* mred = smem + Tl::kRed;           // (MS, T, 4) power-sum partials
  const int split = blockIdx.x;
  const int ti = blockIdx.y / ntiles;
  const int tj = blockIdx.y - ti * ntiles;
  const bool diag = ti == tj;
  const bool moments = tj == 0;
  const float* bt = diag ? a_s : b_s;

  const int tid = threadIdx.x;
  const int rep = tid / (Tl::G * Tl::G);
  const int gy = (tid / Tl::G) % Tl::G;
  const int gx = tid % Tl::G;
  const int mrow = tid % T;
  const int msub = tid / T;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;

  const int ncol = (n + Tl::TN - 1) / Tl::TN;
  const int t_end = min((split + 1) * tps, ncol);
  for (int t = split * tps; t < t_end; ++t) {
    const int c0 = t * Tl::TN;
    __syncthreads();   // the previous tile's readers are done
    stage<In, T>(a_s, x, ti * T, c0, k, n);
    if (!diag) stage<In, T>(b_s, x, tj * T, c0, k, n);
    __syncthreads();
    for (int c = rep; c < Tl::TN; c += Tl::R) {
      const float4 av = *reinterpret_cast<const float4*>(a_s + c * Tl::LD + gy * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bt + c * Tl::LD + gx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
    }
    if (moments) {
      for (int c = msub; c < Tl::TN; c += Tl::MS) {
        const float v = a_s[c * Tl::LD + mrow];
        const float v2 = v * v;
        s1 += v;
        s2 += v2;
        s3 += v2 * v;
        s4 += v2 * v2;
      }
    }
  }
  __syncthreads();   // the staged tiles become the reduction buffer

  const int kp = ntiles * T;
  float* gout = gpart + static_cast<size_t>(split) * kp * kp;
  float* red = smem;   // (R, T, T)
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      red[(rep * T + gy * 4 + a) * T + gx * 4 + b] = acc[a][b];
  if (moments) {
    float* m = mred + (msub * T + mrow) * 4;
    m[0] = s1;
    m[1] = s2;
    m[2] = s3;
    m[3] = s4;
  }
  __syncthreads();
  for (int e = tid; e < T * T; e += kThreads) {
    float g = 0.f;
    for (int r = 0; r < Tl::R; ++r) g += red[r * T * T + e];
    const int i = e / T;
    const int j = e - i * T;
    gout[static_cast<size_t>(ti * T + i) * kp + tj * T + j] = g;
  }
  if (moments) {
    float* mout = mpart + static_cast<size_t>(split) * kp * 4;
    for (int e = tid; e < T * 4; e += kThreads) {
      float s = 0.f;
      for (int r = 0; r < Tl::MS; ++r) s += mred[r * T * 4 + e];
      mout[ti * T * 4 + e] = s;
    }
  }
}

// pass 2: every output adds its splits in split order
__global__ void __launch_bounds__(kThreads)
stream_stats_finish(const float* __restrict__ gpart,
                    const float* __restrict__ mpart, float* __restrict__ mom,
                    float* __restrict__ xxt, int k, int kp, int splits) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < k * k) {
    const int i = e / k;
    const int j = e - i * k;
    const float* p = gpart + static_cast<size_t>(i) * kp + j;
    float g = 0.f;
    for (int s = 0; s < splits; ++s) g += p[static_cast<size_t>(s) * kp * kp];
    xxt[e] = g;
  } else if (e < k * k + 4 * k) {
    const int f = e - k * k;
    const float* p = mpart + f;
    float g = 0.f;
    for (int s = 0; s < splits; ++s) g += p[static_cast<size_t>(s) * kp * 4];
    mom[f] = g;
  }
}

int tile_edge(int k) {
  int t = 4;
  while (t < k && t < 64) t *= 2;
  return t;
}

struct Plan {
  int t, ntiles, kp, tps, splits;
};

Plan plan(int k, int n) {
  Plan p;
  p.t = tile_edge(k);
  p.ntiles = (k + p.t - 1) / p.t;
  p.kp = p.ntiles * p.t;
  const int ncol = (n + tile_cols(p.t) - 1) / tile_cols(p.t);
  int want = kTargetBlocks / (p.ntiles * p.ntiles);
  if (want < 1) want = 1;
  p.tps = (ncol + want - 1) / want;
  p.splits = (ncol + p.tps - 1) / p.tps;
  return p;
}

template <typename In, int T>
cudaError_t launch_partial(const In* x, float* gpart, float* mpart, int k,
                           int n, const Plan& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tiling<T>::kSmemFloats;  // <= 48 KB
  dim3 grid(p.splits, p.ntiles * p.ntiles);
  stream_stats_partial<In, T><<<grid, kThreads, smem, stream>>>(
      x, gpart, mpart, k, n, p.ntiles, p.tps);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch(const In* x, float* gpart, float* mpart, int k, int n,
                     const Plan& p, cudaStream_t stream) {
  switch (p.t) {
    case 4: return launch_partial<In, 4>(x, gpart, mpart, k, n, p, stream);
    case 8: return launch_partial<In, 8>(x, gpart, mpart, k, n, p, stream);
    case 16: return launch_partial<In, 16>(x, gpart, mpart, k, n, p, stream);
    case 32: return launch_partial<In, 32>(x, gpart, mpart, k, n, p, stream);
    default: return launch_partial<In, 64>(x, gpart, mpart, k, n, p, stream);
  }
}

}  // namespace

// Floats of workspace the wrapper allocates for (k, n).
extern "C" long long stream_stats_workspace(int k, int n) {
  if (k <= 0 || n <= 0) return 0;
  const Plan p = plan(k, n);
  return static_cast<long long>(p.splits) * p.kp * (p.kp + 4);
}

// dtype: 0 = float32, 1 = bfloat16.  ws holds stream_stats_workspace(k, n)
// floats.
extern "C" int stream_stats(const void* x, int dtype, float* mom, float* xxt,
                            float* ws, int k, int n, void* stream) {
  if (k <= 0 || n <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(k, n);
  float* gpart = ws;
  float* mpart = ws + static_cast<size_t>(p.splits) * p.kp * p.kp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? dispatch(static_cast<const float*>(x), gpart, mpart, k, n, p, s)
      : dispatch(static_cast<const __nv_bfloat16*>(x), gpart, mpart, k, n,
                 p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = k * k + 4 * k;
  stream_stats_finish<<<(outs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gpart, mpart, mom, xxt, k, p.kp, p.splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stream_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
