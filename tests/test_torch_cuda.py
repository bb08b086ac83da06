"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one; on the card
run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.polyfit import ops as poly_ops
from repro_torch.kernels.polyfit.ref import polyfit_ref
from repro_torch.kernels.stream_stats import ops as ss_ops
from repro_torch.kernels.stream_stats.ref import (fleet_stats_ref,
                                                  stream_stats_ref)

# the Gram block's f32 tolerance, as in tests/test_kernel_stream_stats.py;
# it holds for bf16 input too, since kernel and plain version both sum in
# f32 from the same bf16-rounded values
SS_RTOL, SS_ATOL = 2e-5, 1e-2
# flash attention against the plain version on the card.  f32: max |err|.
# bf16: the tensor-core kernel forms the scores exactly in f32 and carries
# P as two bf16 halves, so like the plain version it is the f32 result
# rounded once, up to summation order: every element is within one bf16
# step (2**-7 |want|), and the RMS of the error stays a small share of the
# output's (a uniform 1.5% error fails)
FA_ATOL_F32 = 1e-5
FA_RTOL_BF16, FA_ATOL_BF16, FA_RMS_BF16 = 1e-2, 1e-4, 2e-3

# the main path's shape, a fleet larger than L2, k = 64 (the site cut into
# chunks of windows), and ragged k and N
FLEET_SHAPES = [(1024, 8, 256), (3, 5, 200), (6, 4, 64), (2, 8, 512),
                (4, 9, 130), (2, 3, 20), (2, 16, 1500), (4096, 8, 1024),
                (1, 64, 4096), (3, 8, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda "
                    "tests/test_torch_cuda.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLEET_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_stream_stats_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 1.5 + 2.0).to(cuda)
    before = ss_ops.LAUNCHES
    got = ss_ops.fleet_window_moments_xxt(x)
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == before + 1
    mom, xxt = fleet_stats_ref(x)
    # the power sums are taken in the plain version's order: bitwise
    assert torch.equal(got[0], mom)
    torch.testing.assert_close(got[1], xxt, rtol=SS_RTOL, atol=SS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(8192, 256), (15, 200), (18, 130),
                                    (3, 20), (2, 1500), (32768, 1024),
                                    (5, 33)])
def test_cuda_polyfit_matches_plain(cuda, rows, n):
    g = torch.Generator().manual_seed(rows + n)
    y = (torch.randn(rows, n, generator=g) * 2.0).to(cuda)
    u = torch.randn(rows, n, generator=g).to(cuda)
    before = poly_ops.LAUNCHES
    pu, py = poly_ops.vandermonde_moments(y, u)
    torch.cuda.synchronize()
    assert poly_ops.LAUNCHES == before + 1
    pu_r, py_r = polyfit_ref(y, u)
    pu_r[:, 0] = float(n)
    # same products, same summation order: bitwise
    assert torch.equal(pu, pu_r) and torch.equal(py, py_r)


WINDOW_SHAPES = [(1, 1), (1, 128), (3, 200), (9, 130), (8, 4096), (32, 8192),
                 (64, 16384), (65, 300), (130, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WINDOW_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_window_moments_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 1.5 + 2.0).to(dtype).to(cuda)
    before = ss_ops.WINDOW_LAUNCHES
    mom, xxt = ss_ops.window_moments_xxt(x)
    torch.cuda.synchronize()
    assert ss_ops.WINDOW_LAUNCHES == before + 1
    mom_r, xxt_r = stream_stats_ref(x)
    torch.testing.assert_close(mom, mom_r, rtol=SS_RTOL, atol=SS_ATOL)
    torch.testing.assert_close(xxt, xxt_r, rtol=SS_RTOL, atol=SS_ATOL)


@pytest.mark.cuda
def test_cuda_window_moments_two_launches_bitwise_equal(cuda):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 16384, generator=g).to(cuda)
    a = ss_ops.stream_stats_cuda(x)
    b = ss_ops.stream_stats_cuda(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (B, S, T, H, KV, hd, causal, window)
FLASH_CASES = [
    (2, 100, 100, 8, 2, 64, True, 32),       # ragged, window, GQA
    (1, 130, 77, 4, 4, 128, False, 0),       # non-causal, ragged S and T
    (1, 200, 200, 4, 2, 240, True, 64),      # gemma3 head dim, window
    (1, 70, 1500, 4, 4, 64, False, 0),       # cross-attention shape
    (2, 64, 64, 2, 1, 16, True, 0),          # one block
    (1, 300, 300, 8, 1, 128, True, 0),       # causal, GQA 8:1
    (1, 96, 160, 2, 2, 32, False, 40),       # window without causal
    (1, 200, 64, 2, 2, 32, True, 16),        # rows 79.. have no live key
    (1, 200, 64, 2, 2, 32, False, 16),       # the same, not causal
]


def _qkv(case, dtype, device):
    b, s, t, h, kv, hd = case[:6]
    g = torch.Generator().manual_seed(s * 7 + t + hd)
    q = torch.randn(b, s, h, hd, generator=g).to(dtype).to(device)
    k = torch.randn(b, t, kv, hd, generator=g).to(dtype).to(device)
    v = torch.randn(b, t, kv, hd, generator=g).to(dtype).to(device)
    return q, k, v


def _assert_bf16_close(out, want):
    out, want = out.float(), want.float()
    torch.testing.assert_close(out, want, rtol=FA_RTOL_BF16,
                               atol=FA_ATOL_BF16)
    rms = ((out - want).square().mean().sqrt()
           / want.square().mean().sqrt()).item()
    assert rms <= FA_RMS_BF16, rms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    q, k, v = _qkv(case, dtype, cuda)
    causal, window = case[6], case[7]
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        err = (out - want).abs().max().item()
        assert err <= FA_ATOL_F32, err
        return
    _assert_bf16_close(out, want)


# f32 only (the CUDA-core kernel): shapes across its tiles (Tile<HD> in
# csrc/flash_attention.cu: 128 query rows, 64 at hd 240; 64 keys, 96 at
# hd 128)
FLASH_CASES_F32 = [
    (1, 129, 257, 4, 2, 128, True, 0),       # S, T one past a tile
    (2, 129, 257, 4, 4, 64, False, 0),       # the same, not causal
    (1, 130, 333, 2, 2, 240, True, 64),      # hd 240, window 64
    (1, 200, 200, 2, 1, 240, True, 16),      # window < a key tile
    (1, 200, 1, 4, 1, 32, True, 0),          # T = 1
    (1, 70, 1, 2, 2, 240, False, 0),         # T = 1, hd 240
    (1, 100, 260, 8, 1, 16, True, 0),        # causal, T > S, GQA 8:1
    (1, 129, 257, 4, 2, 128, False, 100),    # window without causal
    (1, 300, 64, 2, 2, 240, True, 16),       # rows 79.. have no live key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES_F32,
                         ids=lambda c: "x".join(map(str, c)))
def test_cuda_flash_attention_f32_tiles_match_plain(cuda, case):
    q, k, v = _qkv(case, torch.float32, cuda)
    causal, window = case[6], case[7]
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = (out - want).abs().max().item()
    assert err <= FA_ATOL_F32, err


@pytest.mark.cuda
@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
def test_cuda_flash_attention_f32_two_launches_bitwise_equal(cuda, hd):
    q, k, v = _qkv((2, 333, 333, 8, 2, hd), torch.float32, cuda)
    a = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=100)
    b = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=100)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_entry_refuses_bf16_and_misalignment(cuda):
    """The CUDA-core library has no bf16 kernel: its entry point returns
    cudaErrorInvalidValue (1) for dtype code 1.  Its cp.async copies need
    16-byte aligned f32 tensors, and the wrapper refuses others."""
    from repro_torch.kernels import build
    q, k, v = _qkv((1, 64, 64, 2, 2, 64), torch.bfloat16, cuda)
    o = torch.empty_like(q)
    fn = build.load("flash_attention", fa_ops._ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
            build.DTYPE_CODES[torch.bfloat16], 1, 64, 64, 2, 2, 64, 1, 0,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 1
    q, k, v = _qkv((1, 64, 64, 2, 2, 64), torch.float32, cuda)
    flat = torch.zeros(k.numel() + 1, device=cuda)
    shifted = flat[1:].view(k.shape)      # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.flash_attention(q, shifted, v)


@pytest.mark.cuda
def test_cuda_flash_attention_two_launches_bitwise_equal(cuda):
    q, k, v = _qkv(FLASH_CASES[2], torch.bfloat16, cuda)
    a = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=64)
    b = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=64)
    assert torch.equal(a, b)


# the tensor-core (bf16) kernel: (B, S, T, H, KV, causal, window) per mask
# mode, S and T off the 64-row tiles.  "window": rows whose first visited
# key block is wholly masked (its exp(0) terms are erased by the first
# live key's correction factor)
TC_MODES = {
    "causal_gqa4_b2": (2, 333, 333, 8, 2, True, 0),
    "window_gqa8": (1, 333, 333, 8, 1, True, 40),
    "cross_gqa1_b2": (2, 200, 333, 4, 4, False, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(TC_MODES))
@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
def test_cuda_flash_attention_tensor_cores_match_plain(cuda, hd, mode):
    b, s, t, h, kv, causal, window = TC_MODES[mode]
    q, k, v = _qkv((b, s, t, h, kv, hd), torch.bfloat16, cuda)
    before, before_tc = fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES) == (before + 1,
                                                       before_tc + 1)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    _assert_bf16_close(out, flash_attention_ref(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
def test_cuda_flash_attention_tensor_cores_two_launches_bitwise_equal(cuda,
                                                                      hd):
    q, k, v = _qkv((2, 333, 333, 8, 2, hd), torch.bfloat16, cuda)
    a = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=100)
    b = fa_ops.flash_attention_cuda(q, k, v, causal=True, window=100)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_routes_by_dtype(cuda):
    """bf16 calls raise the tensor-core kernel's count, f32 calls only the
    total."""
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v = _qkv(FLASH_CASES[0], dtype, cuda)
        before, before_tc = fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES
        fa_ops.flash_attention(q, k, v, causal=True, window=32)
        torch.cuda.synchronize()
        assert fa_ops.LAUNCHES == before + 1
        assert fa_ops.SM90_LAUNCHES == before_tc + tc


@pytest.mark.cuda
def test_cuda_flash_attention_tensor_cores_refuse_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 64, 64, 2, 2, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="T >= 1"):
        fa_ops.flash_attention(q, k[:, :0], v[:, :0])
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)      # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.flash_attention(shifted, k, v)


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.ones(4, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss_ops.stream_stats_cuda(x.double())
    with pytest.raises(ValueError, match=r"\(k, N\)"):
        ss_ops.stream_stats_cuda(x[None])
    with pytest.raises(ValueError, match="contiguous"):
        ss_ops.stream_stats_cuda(x.t())
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.stream_stats_cuda(x.cpu())
    q, k, v = _qkv(FLASH_CASES[0], torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    with pytest.raises(ValueError, match="H % KV"):
        fa_ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_cuda(q, k.cpu(), v)
