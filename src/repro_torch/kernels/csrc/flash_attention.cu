// Forward attention with an online softmax (flash attention) in f32 on the
// CUDA cores, GQA, causal and sliding-window masks, ragged sequence lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel) for f32 calls.  For q (B, S, H, hd)
// and k, v (B, T, KV, hd), contiguous f32 with 16-byte aligned bases and
// H % KV == 0, it writes o (B, S, H, hd):
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / (H / KV)] / sqrt(hd))
//                 * v[b, j, h / (H / KV)]
// over the keys j < T that the masks keep: j <= i when causal, i - j <
// window when window > 0.  Scores, running max, denominator and
// accumulator are f32 (no TF32, no tensor cores); scores are kept in log2
// units (q . k * log2(e) / sqrt(hd), then 2^x).  A masked score is -1e30
// (not -inf) and the running max starts there, so a key block whose every
// score is masked adds exp(0) = 1 per key until the first live key, whose
// correction factor exp2(-1e30 - m) = 0 then wipes it, exactly as in the
// TPU kernel.  The denominator is clamped at 1e-30.  bf16 calls go to
// csrc/flash_attention_sm90.cu (tensor cores); the entry point here refuses
// them.
//
// Rows with no live key (window > 0 and i >= T + window - 1: the window
// starts past the last key) get what the plain version gives them, a
// softmax over T scores of -1e30 each: the mean of v over all T keys of
// their kv head.  attn_v_mean computes that mean in f32, once per (b, kv
// head), for either type, and the epilogue of this kernel or of the
// tensor-core one writes it to those rows; the wrapper launches it only
// when the shape has such rows (S >= T + window).  Rows with live keys are
// not touched.
//
// What bounds it: 4 hd flops per unmasked (query, key) pair against one
// read of q, k, v and one write of o, so at prefill lengths the kernel is
// bound by f32 arithmetic: 2 hd FFMAs per pair on the CUDA cores (yi-9b
// heads at S = T = 4096, causal: 137 GFLOP against 151 MB).  An SM's four
// schedulers issue four warp-FFMAs a cycle, and it delivers 128 bytes a
// cycle from shared memory to registers, so a 128-bit shared load costs a
// warp four cycles whatever its broadcast: to keep the FFMAs busy, a
// thread must do about four FFMAs for every float it loads from shared
// memory.  The register tiles below are sized for that.
//
// Design.  One block of 256 threads (8 warps) owns a (b, h, query tile)
// and walks the key tiles in a loop; the query tiles are taken in reverse
// order so that the longest causal tiles start first.  A warp's lanes form
// TR = 32 / TC thread rows of TC thread columns (Tile below: TC = 16 at hd
// 64, 128 and 240); a thread owns RPT query rows (tr, tr + TR, ...) of its
// warp's, so the running max, the denominator and the correction factors
// of a row live in the registers of the TC lanes that share it.
//  - Staging: q's tile once, then K and V tiles of BK keys, by cp.async
//    (16 bytes a copy, bypassing registers) into two slots, K_t in one and
//    V_t in the other: V_t is copied while the scores of K_t are computed,
//    K_{t+1} while P_t V_t is.  Rows past S or T are stored as zeros, so no
//    padded copy of q, k or v is made.  Tiles are row-major (keys or
//    queries by head dim) with pitches of 4 mod 8 floats, so the float4
//    reads below hit distinct bank quads in each quarter warp.
//  - Scores: each thread computes RPT rows x BK / TC keys (keys tc,
//    tc + TC, ...) of S = q k^T, reading q and k as float4 along the head
//    dim: at hd 128, 8 rows x 6 keys, 3.4 FFMAs per float loaded.
//  - Softmax: mask (only in tiles that cross the diagonal, the window edge
//    or T), max over the row by shuffles among its TC lanes, exp2 on the
//    SFU (ex2.approx: relative error ~2^-22), P written to the warp's rows
//    of a shared P tile (pitch TC mod 32: the writes and the float4 reads
//    are conflict-free); each thread keeps the partial denominator of its
//    own keys, summed across the row once at the end.
//  - P V: each thread adds P (its RPT rows, float4 over 4 keys) V (float4
//    column chunks tc, tc + TC, ...) into RPT rows x hd / TC columns held
//    in registers: at hd 128, 8 x 8, 4 FFMAs per float loaded.  hd 16 and
//    240 are padded to 32 and 256 columns of zeros in V's slot.
//  - Order: every sum is taken in a fixed order with no atomics, so two
//    launches give the same bits.
// Key tiles wholly in the future (causal) or wholly before the window are
// never visited; GQA reads kv head h / (H / KV) in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tile of each head dim: a warp's lanes form 32 / kTC thread rows of
// kTC thread columns (lane = kTC tr + tc), each thread owns kRPT query
// rows, so a block owns 8 warps x (32 / kTC) x kRPT rows; kBK keys per
// tile.  tests/test_torch_flash_attention.py reads this table (one line
// per head dim, in this form) for its emulation of the kernel's walk.
template <int HD> struct Tile;
template <> struct Tile<16> { static constexpr int kTC = 8, kRPT = 4, kBK = 64; };
template <> struct Tile<32> { static constexpr int kTC = 8, kRPT = 4, kBK = 64; };
template <> struct Tile<64> { static constexpr int kTC = 16, kRPT = 8, kBK = 64; };
template <> struct Tile<128> { static constexpr int kTC = 16, kRPT = 8, kBK = 96; };
template <> struct Tile<240> { static constexpr int kTC = 16, kRPT = 4, kBK = 64; };

template <int HD>
struct Layout {
  static constexpr int kTC = Tile<HD>::kTC;
  static constexpr int kTR = 32 / kTC;
  static constexpr int kRPT = Tile<HD>::kRPT;
  static constexpr int kBK = Tile<HD>::kBK;
  static constexpr int kBQ = kWarps * kTR * kRPT;        // query rows per block
  static constexpr int kHDP = (HD + 4 * kTC - 1) / (4 * kTC) * (4 * kTC);
  static constexpr int kNC = kHDP / (4 * kTC);           // V chunks per thread
  static constexpr int kNJ = kBK / kTC;                  // keys per thread
  static constexpr int kQP = HD + 4;                     // q pitch, 4 mod 8
  static constexpr int kSP = kHDP + 4;                   // K / V pitch, 4 mod 8
  static constexpr int kPP = kBK + kTC;                  // P pitch, kTC mod 32
  static constexpr int kQ = kBQ * kQP;
  static constexpr int kSlot = kBK * kSP;
  static constexpr int kP = kBQ * kPP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + 2 * kSlot + kP);
  static_assert(HD % 8 == 0 && kBK % 32 == 0 && kBK % kTC == 0,
                "tile shape");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the SFU, subnormal results flushed to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Copy ROWS rows of HD floats (row stride ``stride`` floats) from ``src``
// into ``dst`` (pitch PITCH) with cp.async, one 16-byte chunk per thread
// and step; rows >= ``valid`` are stored as zeros instead.  Every thread of
// the block calls it; the copies complete with the caller's next commit.
template <int HD, int ROWS, int PITCH>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t stride, int valid) {
  constexpr int kChunks = HD / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    float* d = dst + r * PITCH + 4 * c;
    if (r < valid) {
      cp_async16(d, src + r * stride + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the live keys of query row i, [max(0, i - window + 1), min(T - 1, i)]
// (causal) or [.., T - 1], are none
__device__ __forceinline__ bool no_live_key(int i, int T, int causal,
                                            int window) {
  const int lo = window > 0 ? max(0, i - window + 1) : 0;
  const int hi = causal ? min(T - 1, i) : T - 1;
  return lo > hi;
}

// out[b, kvh, d] = mean over t < T of v[b, t, kvh, d], in f32: warp w sums
// keys w, w + 8, ..., then the eight partial sums are added in warp order
template <typename E, int HD>
__global__ void __launch_bounds__(kThreads)
attn_v_mean(const E* __restrict__ v, float* __restrict__ out, int T, int KV) {
  constexpr int kCols = (HD + 31) / 32;
  __shared__ float red[kWarps][kCols * 32];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const E* vb = v + static_cast<size_t>(b) * T * kv_row + static_cast<size_t>(kvh) * HD;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int t = warp; t < T; t += kWarps)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c * 32 + lane < HD) acc[c] += to_f32(vb[t * kv_row + c * 32 + lane]);
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[warp][c * 32 + lane] = acc[c];
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float sum = red[0][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w][d];
    out[(static_cast<size_t>(b) * KV + kvh) * HD + d] = sum / static_cast<float>(T);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          const float* __restrict__ vmean, int S, int T, int H, int KV,
          int causal, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int RPT = L::kRPT, BK = L::kBK, BQ = L::kBQ;
  constexpr int NC = L::kNC, NJ = L::kNJ, TR = L::kTR, TC = L::kTC;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + L::kQ;
  float* v_s = k_s + L::kSlot;
  float* p_s = v_s + L::kSlot;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31;
  const int tr = lane / TC;
  const int tc = lane % TC;
  // the thread's rows of the tile: row0 + TR * a, a < RPT
  const int row0 = (threadIdx.x >> 5) * TR * RPT + tr;

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const float* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * T * kv_row + static_cast<size_t>(kvh) * HD;
  const float* vb = v + static_cast<size_t>(b) * T * kv_row + static_cast<size_t>(kvh) * HD;

  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / BK * BK;
  const int k_hi = causal ? min(T, q0 + BQ) : T;

  // V's padding columns stay zero (the copies never reach them)
  if constexpr (L::kHDP > HD) {
    constexpr int kPad = L::kHDP - HD;
    for (int e = threadIdx.x; e < BK * kPad; e += kThreads)
      v_s[(e / kPad) * L::kSP + HD + e % kPad] = 0.f;
  }
  stage<HD, BQ, L::kQP>(q_s, qb + q0 * q_row, q_row, min(BQ, S - q0));
  if (k_lo < k_hi)
    stage<HD, BK, L::kSP>(k_s, kb + k_lo * kv_row, kv_row, min(BK, T - k_lo));
  cp_async_commit();

  float m[RPT], l[RPT], acc[RPT][NC][4];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][c][x] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    cp_async_wait_all();
    __syncthreads();   // K_t (and q) landed; every warp is done with V_{t-1}
    stage<HD, BK, L::kSP>(v_s, vb + k0 * kv_row, kv_row, min(BK, T - k0));
    cp_async_commit();

    // S = q k^T: rows row0 + TR a, keys tc + TC n
    float s[RPT][NJ];
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int n = 0; n < NJ; ++n) s[a][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qf[RPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
        qf[a] = ld4(q_s + (row0 + TR * a) * L::kQP + d);
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const float4 kf = ld4(k_s + (tc + TC * n) * L::kSP + d);
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
          s[a][n] = fmaf(qf[a].x, kf.x, s[a][n]);
          s[a][n] = fmaf(qf[a].y, kf.y, s[a][n]);
          s[a][n] = fmaf(qf[a].z, kf.z, s[a][n]);
          s[a][n] = fmaf(qf[a].w, kf.w, s[a][n]);
        }
      }
    }

    // the masks, only where the tile crosses the diagonal, the window's
    // edge or T; then the online softmax, P to the warp's rows of p_s
    const bool full = k0 + BK <= T && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int qp = q0 + row0 + TR * a;
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        float x = s[a][n] * scale_log2;
        if (!full) {
          const int kp = k0 + tc + TC * n;
          bool live = kp < T;
          if (causal) live = live && kp <= qp;
          if (window > 0) live = live && qp - kp < window;
          x = live ? x : kNeg;
        }
        s[a][n] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < TC; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = exp2_approx(m[a] - m_new);
      float sum = 0.f;
      float* prow = p_s + (row0 + TR * a) * L::kPP + tc;
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const float p = exp2_approx(s[a][n] - m_new);
        sum += p;
        prow[TC * n] = p;
      }
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][c][x] *= corr;
    }

    cp_async_wait_all();
    __syncthreads();   // V_t landed; every warp is done with K_t; P visible
    if (k0 + BK < k_hi) {
      stage<HD, BK, L::kSP>(k_s, kb + (k0 + BK) * kv_row, kv_row,
                            min(BK, T - k0 - BK));
      cp_async_commit();
    }

    // acc += P V: rows row0 + TR a, columns 4 (tc + TC c) .. + 3
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pf[RPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
        pf[a] = ld4(p_s + (row0 + TR * a) * L::kPP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = v_s + (j + jj) * L::kSP + 4 * tc;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vf = ld4(vr + 4 * TC * c);
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const float p = lane_of(pf[a], jj);
            acc[a][c][0] = fmaf(p, vf.x, acc[a][c][0]);
            acc[a][c][1] = fmaf(p, vf.y, acc[a][c][1]);
            acc[a][c][2] = fmaf(p, vf.z, acc[a][c][2]);
            acc[a][c][3] = fmaf(p, vf.w, acc[a][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();   // q's copy, where no key tile was visited

  // the denominators: each thread summed its own keys of the row
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int off = 1; off < TC; off <<= 1)
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], off);
  float* ob = o + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * HD;
  const float* vm = vmean == nullptr ? nullptr
      : vmean + (static_cast<size_t>(b) * KV + kvh) * HD;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int qp = q0 + row0 + TR * a;
    if (qp >= S) continue;
    float* orow = ob + qp * q_row;
    if (vm != nullptr && no_live_key(qp, T, causal, window)) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * (tc + TC * c);
        if (col < HD)
          *reinterpret_cast<float4*>(orow + col) = ld4(vm + col);
      }
      continue;
    }
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (tc + TC * c);
      if (col < HD)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[a][c][0] / denom, acc[a][c][1] / denom,
            acc[a][c][2] / denom, acc[a][c][3] / denom);
    }
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   const float* vmean, int B, int S, int T, int H, int KV,
                   int causal, int window, cudaStream_t stream) {
  using L = Layout<HD>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + L::kBQ - 1) / L::kBQ, H, B);
  flash_fwd<HD><<<grid, kThreads, L::kBytes, stream>>>(
      q, k, v, o, vmean, S, T, H, KV, causal, window,
      kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename E, int HD>
cudaError_t launch_v_mean(const void* v, float* out, int B, int T, int KV,
                          cudaStream_t s) {
  attn_v_mean<E, HD><<<dim3(KV, B), kThreads, 0, s>>>(static_cast<const E*>(v),
                                                      out, T, KV);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_v_mean(int hd, const void* v, float* out, int B, int T,
                            int KV, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_v_mean<E, 16>(v, out, B, T, KV, s);
    case 32: return launch_v_mean<E, 32>(v, out, B, T, KV, s);
    case 64: return launch_v_mean<E, 64>(v, out, B, T, KV, s);
    case 128: return launch_v_mean<E, 128>(v, out, B, T, KV, s);
    case 240: return launch_v_mean<E, 240>(v, out, B, T, KV, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (q, k, v and o alike; 16-byte aligned); any other
// code, bfloat16 included, is refused with cudaErrorInvalidValue.  hd in
// {16, 32, 64, 128, 240}.  vmean: null, or flash_attention_v_mean's
// (B, KV, hd) means, written to the rows with no live key.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const float* vmean, int dtype, int B,
                               int S, int T, int H, int KV, int hd,
                               int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      dtype != 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(qf, kf, vf, of, vmean, B, S, T, H, KV, causal, window, s); break;
    case 32: err = launch<32>(qf, kf, vf, of, vmean, B, S, T, H, KV, causal, window, s); break;
    case 64: err = launch<64>(qf, kf, vf, of, vmean, B, S, T, H, KV, causal, window, s); break;
    case 128: err = launch<128>(qf, kf, vf, of, vmean, B, S, T, H, KV, causal, window, s); break;
    case 240: err = launch<240>(qf, kf, vf, of, vmean, B, S, T, H, KV, causal, window, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// out (B, KV, hd), f32: the mean over the T keys of v (B, T, KV, hd) for
// each (b, kv head); dtype 0 = float32, 1 = bfloat16, T >= 1
extern "C" int flash_attention_v_mean(const void* v, int dtype, float* out,
                                      int B, int T, int KV, int hd,
                                      void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
      ? dispatch_v_mean<float>(hd, v, out, B, T, KV, s)
      : dispatch_v_mean<__nv_bfloat16>(hd, v, out, B, T, KV, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
