// Forward attention with an online softmax on Hopper's tensor cores
// (wgmma), K and V staged by TMA; bf16 q, k, v and o, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel) for bf16 inputs; f32 inputs stay
// on the CUDA-core kernel csrc/flash_attention.cu, which holds them to
// 1e-5 without TF32.  Same function and masks as that kernel: for q
// (B, S, H, hd) and k, v (B, T, KV, hd), contiguous, H % KV == 0,
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / (H / KV)] / sqrt(hd))
//                 * v[b, j, h / (H / KV)]
// over the keys j < T that the masks keep: j <= i when causal, i - j <
// window when window > 0.  A masked score is -1e30 (not -inf) and the
// running max starts there, so a key block whose every score is masked
// adds exp(0) = 1 per key until the first live key, whose correction
// factor exp(-1e30 - m) = 0 then wipes it, as in the TPU kernel.  The
// denominator is clamped at 1e-30; o is rounded once to bf16.  Rows with
// no live key (window > 0, i >= T + window - 1) get the plain version's
// answer, the mean of v over all T keys of their kv head: the wrapper
// computes it in f32 (csrc/flash_attention.cu::attn_v_mean) when the shape
// has such rows, and the epilogue writes it, rounded once to bf16.
//
// What bounds it: 4 hd flops per unmasked (query, key) pair against one
// read of q, k, v and one write of o; at prefill lengths that is bf16
// tensor-core work (yi-9b heads, S = T = 4096, causal: 137 GFLOP against
// 17 MB, 0.139 ms at 989 TFLOP/s).  So both products run as wgmma.
//
// Why P is split.  The reference keeps P in f32.  Rounding P once to bf16
// (what FlashAttention-2/3 do) leaves errors 3-16x past the bf16 check
// (|err| <= 1e-4 + 1e-2 |want| per element against the f32 plain
// version).  P is therefore split in registers into P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and P_hi V and P_lo V go into one f32
// accumulator: P is then carried to about 16 bits, and the products of
// bf16 values are exact in f32, so the result differs from the f32 kernel
// by summation order and by o's one rounding.  The split costs a third
// wgmma per key block: 1.5x the tensor-core work of a plain bf16 kernel.
//
// Design.  One block of one warpgroup (128 threads) owns a (b, h, 64-query
// tile) and walks the key tiles of 64 in a loop; the grid is (H, query
// tiles, B) with the tiles in reverse order, so that the longest causal
// tiles of every head start first and heads sharing a kv head run side by
// side (their K and V meet in L2).  Thread 0 issues every TMA load: q's
// tile once, then K and V tiles into a 2-stage ring of shared memory,
// each stage completing on its own mbarrier; the tile two steps ahead is
// loaded while the current one is computed.  Tensor maps are 4-D (hd, heads,
// positions, batch), built on the host per call, so a box never reads
// past its head or batch: TMA zero-fills keys past T, rows past S and,
// for hd < 64 or hd = 240, the columns past hd of the last 64-wide box.
// Every box is 64 columns (128 bytes) with the 128-byte swizzle, and the
// wgmma descriptors use the same swizzle: S = Q K^T reads Q and K as
// K-major operands (hd contiguous), O += P V reads V as the MN-major B
// operand (the transpose flag) and P from registers, where the f32
// accumulator fragment of S already has the layout of wgmma's A fragment.
// The online softmax runs on that fragment: mask (only in key tiles that
// straddle a mask edge), row max over the 4 threads of a row (quad
// shuffles), exp2 with log2(e)/sqrt(hd) folded into the scale, then the
// correction of the running sum.  Each key tile's P V is summed by wgmma
// in an accumulator of its own, and O = O corr + P V is one f32 FMA on
// the CUDA cores.  The tensor cores' f32 sums are not rounded to nearest,
// and one accumulator carried through every key tile drifts: on an H100,
// over the last 256 rows of a 32k-token causal prefill (4,096 wgmma steps
// into each accumulator) the error's RMS was 6.2e-4 of the output's, and
// 1.3e-4 with an accumulator per tile, as the rounding of P and o alone
// gives.  Key tiles wholly in the future (causal) or wholly before the
// window are never visited.  The epilogue divides by max(l, 1e-30),
// converts to bf16 and stores from registers, rows past S not written.
//
// hd = 240, the register-pressure case: the O accumulator is four 64-wide
// column blocks (the last with 48 live columns, the 16 zero-filled ones
// computed and dropped), 128 f32 registers a thread.  With S (32), the two
// P halves (32) and the tile's product taken one column block (32) at a
// time, that fits one warpgroup's 255 registers, so the kernel keeps one
// warpgroup per block and needs no setmaxnreg; up to hd = 128 the tile's
// product covers every column block at once (ptxas -v prints each
// instantiation's registers and spills).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kThreads = 128;   // one warpgroup
constexpr int kBQ = 64;         // queries per block (wgmma M)
constexpr int kBK = 64;         // keys per tile (N of Q K^T, K of P V)
constexpr int kBox = 64;        // hd columns per TMA box: 128 bytes
constexpr int kRow = 128;       // bytes of one box row in shared memory
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// return codes above this are kEncodeError + the CUresult of
// cuTensorMapEncodeTiled; codes below are cudaError_t values
constexpr int kEncodeError = 100000;

template <int HD>
struct Cfg {
  static constexpr int kChunks = (HD + kBox - 1) / kBox;   // 64-wide boxes
  static constexpr int kKSteps = HD / 16;                  // k16 steps of Q K^T
  static constexpr int kQBytes = kChunks * kBQ * kRow;
  static constexpr int kTileBytes = kChunks * kBK * kRow;  // one K or V tile
  // q, 2 K stages, 2 V stages, and slack to align the base to 1024 bytes
  static constexpr int kSmem = kQBytes + 4 * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the barrier's phase with this parity completes; a load that
// never lands traps (the launch fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box {64 columns, 1 head, rows, 1 batch} at (col, head, row, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the wgmma that owns it until the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(1) << 62;
}

#define ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) {=, +=} A (64 x 16) B (16 x 64), both from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) {=, +=} A (64 x 16, registers) B (16 x 64, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// thread 0: key tile ``it`` (keys k0 ..) of K and V into stage it % 2, one
// 64-column box per chunk, each stage completing on its own mbarrier
template <int NC>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t k_s,
                                        uint32_t v_s, uint32_t bar_k,
                                        uint32_t bar_v, int it, int k0,
                                        int kvh, int b) {
  constexpr int kTile = NC * kBK * kRow;
  const int st = it & 1;
  mbar_expect_tx(bar_k + 8 * st, kTile);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(k_s + st * kTile + c * kBK * kRow, kmap, bar_k + 8 * st,
             c * kBox, kvh, k0, b);
  mbar_expect_tx(bar_v + 8 * st, kTile);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(v_s + st * kTile + c * kBK * kRow, vmap, bar_v + 8 * st,
             c * kBox, kvh, k0, b);
}

// Accumulator fragment of m64nN (f32): register i of thread (warp w,
// lane l) holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.  For k16 step kk of P V, registers
// 8 kk .. 8 kk + 7 of S are, pairwise, exactly wgmma's A fragment.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o,
               const float* __restrict__ vmean, int S, int T, int H, int KV,
               int causal, int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int NC = C::kChunks;
  // column blocks whose P V products are in flight together: all of them
  // up to hd = 128, one at a time at hd = 240 (registers)
  constexpr int kGroup = NC <= 2 ? NC : 1;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];   // q, K stages 0-1, V stages 0-1

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;
  const uint32_t v_s = k_s + 2 * C::kTileBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);   // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[3]);

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / kBK * kBK;
  const int k_hi = causal ? min(T, q0 + kBQ) : T;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(q_s + c * kBQ * kRow, &qmap, bar_q, c * kBox, h, q0, b);
    for (int it = 0; it < min(2, n_tiles); ++it)
      load_kv<NC>(&kmap, &vmap, k_s, v_s, bar_k, bar_v, it, k_lo + it * kBK,
                  kvh, b);
  }

  const int r0 = q0 + warp * 16 + (lane >> 2);   // this thread's rows r0, r0 + 8
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};     // this thread's share of the row sums
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = k_lo + it * kBK;

    // S = Q K^T
    mbar_wait(bar_k + 8 * st, parity);
    float s[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < C::kKSteps; ++ks) {
      const uint32_t col = (ks & 3) * 32;   // bytes into the 128-byte row
      wgmma_ss(s, smem_desc(q_s + (ks >> 2) * (kBQ * kRow) + col, 16, 1024),
               smem_desc(k_s + st * C::kTileBytes + (ks >> 2) * (kBK * kRow)
                         + col, 16, 1024),
               ks > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // online softmax on the fragment, in log2 units
    const bool edge = k0 + kBK > T || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int qp = r0 + 8 * ((i >> 1) & 1);
        const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        bool live = kp < T;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && qp - kp < window;
        x = live ? x : kNeg;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
    // P = P_hi + P_lo, both bf16, as wgmma A fragments
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], bb = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, bb);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][r] = bits(hi);
        p_lo[kk][r] = bits(__floats2bfloat162_rn(a - hf.x, bb - hf.y));
      }

    // O = O corr + (P_hi V + P_lo V): the tile's product in its own
    // accumulator, kGroup column blocks at a time, added to O by one FMA
    mbar_wait(bar_v + 8 * st, parity);
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += kGroup) {
      float pv[kGroup][32];
      wg_fence();
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(v_s + st * C::kTileBytes +
                                        (c0 + g) * (kBK * kRow) +
                                        kk * 16 * kRow, kBK * kRow, 1024);
          wgmma_rs(pv[g], p_hi[kk], db, kk > 0);
          wgmma_rs(pv[g], p_lo[kk], db, 1);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        fence_regs(pv[g]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[c0 + g][i] = fmaf(acc[c0 + g][i], corr[(i >> 1) & 1], pv[g][i]);
      }
    }

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + 2 < n_tiles)
      load_kv<NC>(&kmap, &vmap, k_s, v_s, bar_k, bar_v, it + 2,
                  k0 + 2 * kBK, kvh, b);
  }

  float denom[2];
  bool dead[2];   // rows with no live key: [max(0, i - window + 1), hi] empty
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
    const int row = r0 + 8 * r;
    const int lo = window > 0 ? max(0, row - window + 1) : 0;
    const int hi = causal ? min(T - 1, row) : T - 1;
    dead[r] = vmean != nullptr && lo > hi;
  }
  const float* vm = vmean == nullptr ? nullptr
      : vmean + (static_cast<size_t>(b) * KV + kvh) * HD;
  const size_t row_stride = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * S * row_stride +
                      static_cast<size_t>(h) * HD;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * kBox + 8 * j + 2 * (lane & 3);
      if (col >= HD) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= S) continue;
        *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + col) =
            dead[r] ? __floats2bfloat162_rn(vm[col], vm[col + 1])
                    : __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / denom[r],
                                            acc[c][4 * j + 2 * r + 1] /
                                                denom[r]);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// that nothing links libcuda by hand
cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// (B, L, NH, HD) bf16, contiguous: 4-D map (HD, NH, L, B), box
// {64, 1, rows, 1}, 128-byte swizzle, zero fill out of bounds
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                  int L, int NH, int HD, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(HD) * 2;
  const cuuint64_t strides[3] = {row, row * NH, row * NH * L};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* vmean, int B, int S, int T, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  EncodeTiled enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  CUresult r = make_map(enc, &qm, q, B, S, H, HD, kBQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &km, k, B, T, KV, HD, kBK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &vm, v, B, T, KV, HD, kBK);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  constexpr int smem = Cfg<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_fwd_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  flash_fwd_sm90<HD><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), vmean, S, T, H, KV, causal,
      window, kLog2e / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and o; hd in {16, 32, 64, 128, 240}; T >= 1; every pointer
// 16-byte aligned.  vmean: null, or the (B, KV, hd) f32 means of v written
// to the rows with no live key.  Returns 0, a cudaError_t, or 100000 + the
// CUresult of a failed cuTensorMapEncodeTiled.
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* o, const float* vmean,
                                    int B, int S, int T, int H, int KV, int hd,
                                    int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, vmean, B, S, T, H, KV, causal, window, s);
    case 32: return launch<32>(q, k, v, o, vmean, B, S, T, H, KV, causal, window, s);
    case 64: return launch<64>(q, k, v, o, vmean, B, S, T, H, KV, causal, window, s);
    case 128: return launch<128>(q, k, v, o, vmean, B, S, T, H, KV, causal, window, s);
    case 240: return launch<240>(q, k, v, o, vmean, B, S, T, H, KV, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  static char buf[96];
  if (err >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
