// Forward attention with an online softmax (flash attention), GQA,
// causal and sliding-window masks, ragged sequence lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel).  For q (B, S, H, hd) and k, v
// (B, T, KV, hd), contiguous, all f32 or all bf16, with H % KV == 0, it
// writes o (B, S, H, hd) in q's type:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / (H / KV)] / sqrt(hd))
//                 * v[b, j, h / (H / KV)]
// over the keys j < T that the masks keep: j <= i when causal, i - j <
// window when window > 0.  Scores, running max, denominator and
// accumulator are f32; a masked score is -1e30 (not -inf) and the running
// max starts there, so a key block whose every score is masked adds
// exp(0) = 1 per key until the first live key, whose correction factor
// exp(-1e30 - m) = 0 then wipes it, exactly as in the TPU kernel.  The
// denominator is clamped at 1e-30.
//
// Rows with no live key (window > 0 and i >= T + window - 1: the window
// starts past the last key) get what the plain version gives them, a
// softmax over T scores of -1e30 each: the mean of v over all T keys of
// their kv head.  attn_v_mean computes that mean in f32, once per (b, kv
// head), and the epilogue writes it to those rows, rounded once to o's
// type; the wrapper launches it, for either kernel, only when the shape
// has such rows (S >= T + window).  Rows with live keys are not touched.
//
// What bounds it: 4 hd flops per unmasked (query, key) pair against one
// read of q, k, v and one write of o, so at prefill lengths the kernel is
// bound by arithmetic (yi-9b heads, S = T = 32768, causal: 8.8 TFLOP
// against 0.6 GB).  This kernel does its arithmetic in f32 on the CUDA
// cores, which keeps f32 calls within 1e-5 of the plain version (no TF32);
// the wrapper (kernels/flash_attention/ops.py) sends it f32 calls only.
// bf16 calls go to csrc/flash_attention_sm90.cu, on the tensor cores
// (wgmma, TMA); of the bf16 code here only attn_v_mean is launched.
//
// Design.  The TPU kernel's grid (B, H, S/128, T/128) keeps the running
// max, denominator and accumulator in VMEM across its sequential kv axis.
// Here one block of 256 threads owns a (b, h, 64-query tile) and walks the
// key blocks of 64 in a loop.  q's tile is staged transposed in shared
// memory once; for each key block K is staged transposed, the 64 x 64
// scores are computed 4 x 4 per thread (16 x 16 threads, float4 loads),
// masked and folded into the running max and denominator, the
// probabilities go to shared memory, V is staged into the buffer K used,
// and each thread adds P V into its 4 rows x hd/16 columns of the
// accumulator in registers.  Key blocks wholly in the future (causal) or
// wholly before the window are never visited.  Rows past S are computed
// on zeros and not written; keys past T are staged as zeros and masked,
// so no padded copy of q, k or v is made.  GQA reads kv head h / (H / KV)
// in place.  The query tiles are taken in reverse order so that the
// longest causal tiles start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per step
constexpr int kLD = 68;     // stride of the transposed tiles, float4-aligned
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the live keys of query row i, [max(0, i - window + 1), min(T - 1, i)]
// (causal) or [.., T - 1], are none
__device__ __forceinline__ bool no_live_key(int i, int T, int causal,
                                            int window) {
  const int lo = window > 0 ? max(0, i - window + 1) : 0;
  const int hi = causal ? min(T - 1, i) : T - 1;
  return lo > hi;
}

template <int HD>
struct Smem {
  static constexpr int kQ = HD * kLD;                       // (hd, BQ) q^T
  static constexpr int kKV = (HD * kLD > kBK * HD) ? HD * kLD : kBK * HD;
  static constexpr int kP = kBK * kLD;                      // (BK, BQ) p^T
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKV + kP);
};

// out[b, kvh, d] = mean over t < T of v[b, t, kvh, d], in f32: warp w sums
// keys w, w + 8, ..., then the eight partial sums are added in warp order
template <typename E, int HD>
__global__ void __launch_bounds__(kThreads)
attn_v_mean(const E* __restrict__ v, float* __restrict__ out, int T, int KV) {
  constexpr int kCols = (HD + 31) / 32;
  constexpr int kW = kThreads / 32;
  __shared__ float red[kW][kCols * 32];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const E* vb = v + static_cast<size_t>(b) * T * kv_row + static_cast<size_t>(kvh) * HD;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int t = warp; t < T; t += kW)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c * 32 + lane < HD) acc[c] += to_f32(vb[t * kv_row + c * 32 + lane]);
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[warp][c * 32 + lane] = acc[c];
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float sum = red[0][d];
#pragma unroll
    for (int w = 1; w < kW; ++w) sum += red[w][d];
    out[(static_cast<size_t>(b) * KV + kvh) * HD + d] = sum / static_cast<float>(T);
  }
}

// NB = hd / 16 accumulator columns per thread
template <typename E, int NB>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, E* __restrict__ o,
          const float* __restrict__ vmean, int S, int T, int H, int KV,
          int causal, int window, float scale) {
  constexpr int HD = NB * 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kv_s = q_s + Smem<HD>::kQ;
  float* p_s = kv_s + Smem<HD>::kKV;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // rows ty*4 .. ty*4+3
  const int tx = tid & 15;      // score columns tx*4 .. tx*4+3, acc cols tx+16c

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const E* qb = q + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * HD;
  const E* kb = k + (static_cast<size_t>(b) * T) * kv_row + static_cast<size_t>(kvh) * HD;
  const E* vb = v + (static_cast<size_t>(b) * T) * kv_row + static_cast<size_t>(kvh) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD;
    const int d = e - i * HD;
    q_s[d * kLD + i] = (q0 + i < S) ? to_f32(qb[(q0 + i) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c) acc[a][c] = 0.f;
  }

  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / kBK * kBK;
  const int k_hi = causal ? min(T, q0 + kBQ) : T;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // q_s staged / the previous block's P V is done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      kv_s[d * kLD + j] = (k0 + j < T) ? to_f32(kb[(k0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + d * kLD + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kv_s + d * kLD + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], ka[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty * 4 + a;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        bool live = kp < T;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && qp - kp < window;
        s[a][c] = live ? s[a][c] * scale : kNeg;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NB; ++c) acc[a][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(p_s + (tx * 4 + c) * kLD + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();   // scores read K from kv_s; P is complete

    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      kv_s[j * HD + d] = (k0 + j < T) ? to_f32(vb[(k0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(p_s + j * kLD + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vr = kv_s + j * HD + tx;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float vv = vr[c * 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

  E* ob = o + (static_cast<size_t>(b) * S) * q_row + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    if (qp >= S) continue;
    if (vmean != nullptr && no_live_key(qp, T, causal, window)) {
      const float* vm = vmean + (static_cast<size_t>(b) * KV + kvh) * HD;
#pragma unroll
      for (int c = 0; c < NB; ++c)
        store(ob + qp * q_row + tx + 16 * c, vm[tx + 16 * c]);
      continue;
    }
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      store(ob + qp * q_row + tx + 16 * c, acc[a][c] / denom);
  }
}

template <typename E, int NB>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const float* vmean, int B, int S, int T, int H, int KV,
                   int causal, int window, cudaStream_t stream) {
  constexpr int HD = NB * 16;
  const size_t smem = Smem<HD>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<E, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<E, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), vmean, S, T, H, KV,
      causal, window, 1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, const float* vm, int B, int S, int T, int H,
                     int KV, int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<E, 1>(q, k, v, o, vm, B, S, T, H, KV, causal, window, s);
    case 32: return launch<E, 2>(q, k, v, o, vm, B, S, T, H, KV, causal, window, s);
    case 64: return launch<E, 4>(q, k, v, o, vm, B, S, T, H, KV, causal, window, s);
    case 128: return launch<E, 8>(q, k, v, o, vm, B, S, T, H, KV, causal, window, s);
    case 240: return launch<E, 15>(q, k, v, o, vm, B, S, T, H, KV, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  hd in
// {16, 32, 64, 128, 240}.  vmean: null, or flash_attention_v_mean's
// (B, KV, hd) means, written to the rows with no live key.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const float* vmean, int dtype, int B,
                               int S, int T, int H, int KV, int hd,
                               int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
      ? dispatch<float>(hd, q, k, v, o, vmean, B, S, T, H, KV, causal,
                        window, s)
      : dispatch<__nv_bfloat16>(hd, q, k, v, o, vmean, B, S, T, H, KV,
                                causal, window, s);
  return static_cast<int>(err);
}

// out (B, KV, hd), f32: the mean over the T keys of v (B, T, KV, hd) for
// each (b, kv head); dtype as above, T >= 1
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
