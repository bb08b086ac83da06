"""The port's flash attention against the JAX package on the CPU.

On the CPU ``flash_attention`` takes its plain version; it is held against
the reference's jnp oracle on the reference's own shape cases, and on two
of them against the reference's Pallas kernel in interpret mode.  The CUDA
kernels are held against the plain version on the card by
``test_torch_cuda.py``.  Here, the bf16 tensor-core kernel's rounding is
emulated in plain torch and held to the card's bf16 limits.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref as plain_flash

# the cases and tolerances of tests/test_kernel_flash_attention.py
CASES = [
    (64, 64, 4, 2, 16, True, 0),       # GQA causal
    (48, 48, 4, 4, 32, True, 16),      # sliding window
    (32, 80, 2, 1, 16, False, 0),      # cross-attn shape, ragged keys
    (100, 100, 8, 2, 64, True, 32),    # non-power-of-two, window
    (16, 16, 2, 2, 8, True, 0),        # tiny
]
ATOL = {"float32": 2e-6, "bfloat16": 3e-2}


def _inputs(s, t, h, kv, hd, b=2):
    rng = np.random.default_rng(s * 7 + t)
    return (rng.normal(0, 1, (b, s, h, hd)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.LAUNCHES == before
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kv,hd,causal,window", CASES)
def test_plain_matches_reference_oracle(s, t, h, kv, hd, causal, window,
                                        dtype):
    arrays = _inputs(s, t, h, kv, hd)
    want = flash_attention_ref(*(jnp.asarray(a, dtype) for a in arrays),
                               causal=causal, window=window)
    got = _port(arrays, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("s,t,h,kv,hd,causal,window", [CASES[4], CASES[2]])
def test_plain_matches_reference_kernel_interpret(s, t, h, kv, hd, causal,
                                                  window):
    arrays = _inputs(s, t, h, kv, hd)
    want = ref_flash(*(jnp.asarray(a) for a in arrays), causal=causal,
                     window=window, interpret=True)
    got = _port(arrays, "float32", causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_gqa_matches_a_loop_over_heads(causal, window):
    """H = 8 query heads on KV = 2 kv heads: head h reads kv head h // 4."""
    s, t, h, kv, hd = 24, 24, 8, 2, 16
    q, k, v = _inputs(s, t, h, kv, hd)
    got = _port((q, k, v), "float32", causal=causal, window=window)
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    live = np.ones((s, t), bool)
    if causal:
        live &= kp <= qp
    if window:
        live &= qp - kp < window
    want = np.empty_like(q, dtype=np.float64)
    for b in range(q.shape[0]):
        for hh in range(h):
            g = hh // (h // kv)
            sc = q[b, :, hh].astype(np.float64) @ k[b, :, g].T / np.sqrt(hd)
            sc = np.where(live, sc, -np.inf)
            p = np.exp(sc - sc.max(1, keepdims=True))
            want[b, :, hh] = (p / p.sum(1, keepdims=True)) @ v[b, :, g]
    np.testing.assert_allclose(got, want, atol=ATOL["float32"])


def test_plain_version_on_a_slice_of_rows():
    """``q_offset`` places a slice of the queries at their positions, as
    the card's check of the last rows of a long prefill does."""
    s, h, kv, hd, r = 40, 4, 2, 16, 8
    q, k, v = (torch.as_tensor(a) for a in _inputs(s, s, h, kv, hd))
    for causal, window in ((True, 0), (True, 6), (False, 6)):
        full = plain_flash(q, k, v, causal=causal, window=window)
        tail = plain_flash(q[:, -r:], k, v, causal=causal, window=window,
                           q_offset=s - r)
        torch.testing.assert_close(tail, full[:, -r:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "cross"])
def test_plain_matches_reference_oracle_on_rows_without_keys(causal):
    """S >= T + window: query rows i >= T + window - 1 have no live key.
    The reference's oracle gives them a softmax over T scores of -1e30,
    the mean of v over all T keys, and so must the port (both CUDA kernels
    write that mean; test_torch_cuda.py holds them to it on the card)."""
    s, t, h, kv, hd, window = 200, 64, 2, 2, 32, 16
    arrays = _inputs(s, t, h, kv, hd, b=1)
    want = np.asarray(flash_attention_ref(*(jnp.asarray(a) for a in arrays),
                                          causal=causal, window=window))
    got = _port(arrays, "float32", causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=ATOL["float32"])
    dead = t + window - 1
    assert fa_ops.has_rows_without_keys(s, t, window)
    assert not fa_ops.has_rows_without_keys(dead, t, window)
    mean_v = arrays[2].astype(np.float64).mean(axis=1)       # (B, KV, hd)
    np.testing.assert_allclose(got[:, dead:], np.broadcast_to(
        mean_v[:, None], got[:, dead:].shape), atol=ATOL["float32"])
    assert not np.allclose(got[:, dead - 1], mean_v, atol=1e-3)


def test_flash_kernel_entry_refuses_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _inputs(16, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_cuda(q, k, v)


# The bf16 tensor-core kernel (csrc/flash_attention_sm90.cu), emulated:
# bf16 inputs, exact products summed in f32, the online softmax over key
# tiles of 64 in log2 units, P rounded to bf16 for the tensor cores, the
# output rounded once to bf16.  The card's bf16 limits, as in chip_smoke.py
# and test_torch_cuda.py: every |err| <= 1e-4 + 1e-2 |want| and RMS(err)
# <= 2e-3 RMS(want), against the plain version on the same bf16 inputs.
BF16_RTOL, BF16_ATOL, BF16_RMS = 1e-2, 1e-4, 2e-3
# (B, S, T, H, KV, hd, causal, window): every head dim, causal, windowed
# and cross-attention, ragged tiles, GQA 1, 2, 4 and 8
EMULATED = [
    (1, 512, 512, 2, 2, 16, False, 0),
    (2, 333, 333, 4, 1, 32, True, 0),
    (1, 256, 256, 8, 1, 64, True, 0),
    (1, 384, 384, 4, 1, 128, True, 100),
    (1, 200, 333, 2, 2, 240, False, 0),
]


def _emulate_tensor_cores(q, k, v, *, causal, window, split, bk=64):
    """The kernel's arithmetic on bf16 q (B,S,H,hd), k, v (B,T,KV,hd):
    ``split`` feeds P to the products as P_hi = bf16(P) and P_lo =
    bf16(P - P_hi), both into one f32 accumulator, as the kernel does;
    otherwise P is rounded once to bf16."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = torch.repeat_interleave(k.float(), h // kv, 2).transpose(1, 2)
    vf = torch.repeat_interleave(v.float(), h // kv, 2).transpose(1, 2)
    scale = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    qp = torch.arange(s)[:, None]
    for k0 in range(0, t, bk):
        kp = torch.arange(k0, min(t, k0 + bk))[None, :]
        live = torch.ones(s, kp.shape[1], dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window > 0:
            live &= qp - kp < window
        sc = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        sc = torch.where(live, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, :, k0:k0 + bk]
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


def _bf16_scores(case, split):
    """(max |err| / (atol + rtol |want|), RMS(err) / RMS(want)) of the
    emulation against the plain version."""
    b, s, t, h, kv, hd, causal, window = case
    rng = np.random.default_rng(s + t + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               .bfloat16() for shape in ((b, s, h, hd), (b, t, kv, hd),
                                         (b, t, kv, hd)))
    got = _emulate_tensor_cores(q, k, v, causal=causal, window=window,
                                split=split).float()
    want = plain_flash(q, k, v, causal=causal, window=window).float()
    d, w = (got - want).abs(), want.abs()
    return (float((d / (BF16_ATOL + BF16_RTOL * w)).max()),
            float(d.square().mean().sqrt() / w.square().mean().sqrt()))


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(map(str, c)))
def test_split_p_emulation_meets_the_bf16_limits(case):
    """P as two bf16 halves: within the card's limits (err/tol ~0.6-0.7)."""
    scaled, rms = _bf16_scores(case, split=True)
    assert scaled <= 1.0 and rms <= BF16_RMS, (scaled, rms)


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(map(str, c)))
def test_single_bf16_p_emulation_exceeds_the_bf16_limits(case):
    """P rounded once to bf16, as FlashAttention-2/3 do, fails the
    per-element limit several times over: the reason the kernel splits P."""
    scaled, _ = _bf16_scores(case, split=False)
    assert scaled > 2.0, scaled


# The f32 CUDA-core kernel (csrc/flash_attention.cu), its block walk
# emulated: query tiles of bq rows and key tiles of bk keys (the kernel's
# own Tile<HD> table, read from its source) from k_lo (the window's first
# key rounded down to a tile) to k_hi (past the tile's last row when
# causal, else T), rows past T staged as zeros, scores in log2 units
# masked to -1e30 (a row whose visited keys are all masked so far adds
# exp2(0) = 1 per key, wiped by the first live key's correction), the
# denominator clamped at 1e-30, and rows with no live key given the mean
# of v over all T keys.  Held to the card's f32 tolerance against the
# reference's oracle.
F32_ATOL = 1e-5
# (B, S, T, H, KV, hd, causal, window), across the new tiles' edges
F32_WALK = [
    (1, 129, 257, 4, 2, 128, True, 0),      # S, T past a tile; causal
    (2, 200, 333, 2, 2, 64, False, 0),      # neither a multiple of 128
    (1, 130, 1, 2, 1, 32, True, 0),         # T = 1
    (1, 70, 1, 2, 2, 240, False, 0),        # T = 1, hd 240
    (1, 300, 300, 2, 1, 128, True, 20),     # window < a key tile
    (1, 150, 200, 2, 2, 240, True, 16),     # hd 240, window < a key tile
    (1, 100, 260, 2, 2, 64, True, 0),       # causal, T > S
    (1, 150, 150, 8, 1, 32, True, 0),       # GQA 8:1
    (1, 96, 160, 8, 1, 16, False, 40),      # GQA 8:1, window, not causal
    (1, 130, 200, 2, 1, 240, True, 64),     # hd 240, window 64
    (1, 300, 64, 2, 2, 240, True, 16),      # rows 79.. have no live key
    (1, 200, 64, 2, 2, 32, False, 16),      # the same, not causal
]


def _cuda_core_tiles():
    """head dim -> (query rows per block, keys per tile) from the kernel's
    ``Tile<HD>`` lines: 8 warps x 32 / kTC thread rows x kRPT rows."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    return {int(hd): (8 * 32 // int(tc) * int(rpt), int(bk))
            for hd, tc, rpt, bk in re.findall(
                r"struct Tile<(\d+)> \{ static constexpr int kTC = (\d+), "
                r"kRPT = (\d+), kBK = (\d+)", src)}


def _emulate_cuda_cores(q, k, v, *, causal, window):
    """The f32 kernel's walk on f32 q (B,S,H,hd), k, v (B,T,KV,hd).
    Returns the output and the key tiles visited per (b, h)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    bq, bk = _cuda_core_tiles()[hd]
    qf = q.transpose(1, 2)
    kf = torch.repeat_interleave(k, h // kv, 2).transpose(1, 2)
    vf = torch.repeat_interleave(v, h // kv, 2).transpose(1, 2)
    pad = torch.zeros(b, h, bk, hd)
    kf, vf = torch.cat([kf, pad], 2), torch.cat([vf, pad], 2)
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty(b, h, s, hd)
    tiles = 0
    for q0 in range(0, s, bq):
        qp = torch.arange(q0, min(s, q0 + bq))[:, None]
        k_lo = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
        k_hi = min(t, q0 + bq) if causal else t
        m = torch.full((b, h, qp.shape[0], 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, qp.shape[0], hd)
        for k0 in range(k_lo, k_hi, bk):
            tiles += 1
            kp = torch.arange(k0, k0 + bk)[None, :]
            live = kp < t
            if causal:
                live = live & (kp <= qp)
            if window > 0:
                live = live & (qp - kp < window)
            sc = qf[:, :, q0:q0 + bq] @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
            sc = torch.where(live, sc * scale, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, k0:k0 + bk]
            m = m_new
        o = acc / l.clamp_min(1e-30)
        if fa_ops.has_rows_without_keys(s, t, window):
            dead = (qp[:, 0] >= t + window - 1)[None, None, :, None]
            o = torch.where(dead, vf[:, :, :t].mean(2, keepdim=True), o)
        out[:, :, q0:q0 + bq] = o
    return out.transpose(1, 2), tiles


@pytest.mark.parametrize("case", F32_WALK, ids=lambda c: "x".join(map(str, c)))
def test_cuda_core_walk_emulation_matches_reference_oracle(case):
    b, s, t, h, kv, hd, causal, window = case
    arrays = _inputs(s, t, h, kv, hd, b=b)
    want = np.asarray(flash_attention_ref(*(jnp.asarray(a) for a in arrays),
                                          causal=causal, window=window))
    got, tiles = _emulate_cuda_cores(*(torch.as_tensor(a) for a in arrays),
                                     causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    bq, bk = _cuda_core_tiles()[hd]
    every = -(-s // bq) * -(-t // bk)
    # key tiles wholly in the future or before the window are skipped
    last_q0 = (-(-s // bq) - 1) * bq
    skips = (causal and t > bq) or (window > 0
                                    and last_q0 - window + 1 >= bk)
    assert tiles < every if skips else tiles == every


def test_cuda_core_walk_wipes_wholly_masked_tiles():
    """Window 16 < a key tile: query tile 2 (rows 128..191 at hd 240)
    starts its walk at key 64, whose tile is wholly masked for rows >= 143;
    their exp2(0) terms must leave no trace."""
    s, t, h, kv, hd, window = 192, 192, 2, 2, 240, 16
    arrays = _inputs(s, t, h, kv, hd, b=1)
    got, _ = _emulate_cuda_cores(*(torch.as_tensor(a) for a in arrays),
                                 causal=True, window=window)
    want = plain_flash(*(torch.as_tensor(a) for a in arrays), causal=True,
                       window=window)
    assert _cuda_core_tiles()[hd] == (64, 64)
    torch.testing.assert_close(got[:, 143:], want[:, 143:], rtol=0,
                               atol=F32_ATOL)


def test_cuda_core_tiles_cover_every_head_dim():
    """The emulation reads a tile for each head dim the wrapper takes, and
    each query tile is a whole number of 8 warps' rows."""
    tiles = _cuda_core_tiles()
    assert sorted(tiles) == list(fa_ops.HEAD_DIMS)
    assert all(bq % 8 == 0 and bk % 32 == 0 for bq, bk in tiles.values())
