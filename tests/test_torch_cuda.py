"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one; on the card
run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_f64,
                                                     flash_attention_ref)
from repro_torch.kernels.polyfit import ops as poly_ops
from repro_torch.kernels.polyfit.ref import polyfit_ref
from repro_torch.kernels.stream_stats import ops as ss_ops
from repro_torch.kernels.stream_stats.ref import (fleet_stats_ref,
                                                  stream_stats_ref)
from repro_torch.launch.train import random_stub_inputs

# the one-window kernel's Gram f32 tolerance, as in
# tests/test_kernel_stream_stats.py; it holds for bf16 input too, since
# kernel and plain version both sum in f32 from the same bf16-rounded
# values (the fleet kernel's outputs are bitwise the plain version's)
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
    # every sum is taken in the plain version's order: bitwise
    assert torch.equal(got[0], mom)
    assert torch.equal(got[1], xxt)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 20, 23, 32, 33])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_stream_stats_short_rows_in_the_callers_order(cuda, n, fused):
    """Rows of 32 or fewer in the order the caller asks for (S2..S4 as
    multiply-add chains with ``fused``), and a 33-tuple row unchanged by
    it: bitwise the plain version."""
    g = torch.Generator().manual_seed(n)
    x = (torch.randn(6, 8, n, generator=g) * 1.5 + 2.0).to(cuda)
    got = ss_ops.fleet_window_moments_xxt(x, fused=fused)
    torch.cuda.synchronize()
    mom, xxt = fleet_stats_ref(x, fused)
    assert torch.equal(got[0], mom) and torch.equal(got[1], xxt)


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


# every tile edge (8, 16, 32, 64, and tile pairs above k = 64), N off
# the 16-byte copies (N % 4 == 2), and a window larger than L2
WINDOW_SHAPES = [(1, 1), (1, 128), (3, 200), (9, 130), (8, 4096), (32, 8192),
                 (64, 16384), (65, 300), (130, 1000), (64, 262144)]


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
    # one sum for each pair i <= j, written to both triangles
    assert torch.equal(xxt, xxt.T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(9, 130), (64, 4096), (130, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_window_moments_unaligned_slice_matches_plain(cuda, shape,
                                                           dtype):
    """x a contiguous slice one element into a larger buffer: rows and
    base are off the 16-byte copies whatever N is."""
    g = torch.Generator().manual_seed(sum(shape) + 1)
    flat = (torch.randn(shape[0] * shape[1] + 1, generator=g) * 1.5
            + 2.0).to(dtype).to(cuda)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    mom, xxt = ss_ops.window_moments_xxt(x)
    mom_r, xxt_r = stream_stats_ref(x)
    torch.testing.assert_close(mom, mom_r, rtol=SS_RTOL, atol=SS_ATOL)
    torch.testing.assert_close(xxt, xxt_r, rtol=SS_RTOL, atol=SS_ATOL)
    assert torch.equal(xxt, xxt.T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 130), (8, 4096), (130, 1000),
                                   (64, 16384), (64, 262144)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_window_moments_two_launches_bitwise_equal(cuda, shape):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(cuda)
    a = ss_ops.stream_stats_cuda(x)
    b = ss_ops.stream_stats_cuda(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096), (130, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_window_moments_one_kernel_per_call(cuda, shape):
    """A call launches one kernel: the sums across blocks are inside it.
    The host's launch calls are counted (the profiler may drop a kernel
    record, never a runtime call), and every kernel record is the
    window kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(shape, device=cuda)
    ss_ops.stream_stats_cuda(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ss_ops.stream_stats_cuda(x)
        torch.cuda.synchronize()
    launches = [e.name for e in prof.events()
                if e.name.startswith("cudaLaunch")]
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(launches) == 3, launches
    assert kernels and all("stream_stats_window" in n for n in kernels), \
        kernels


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


# ---- one site (E = 1): the sampler, both fleet kernels, single_scan -----

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(5, 256), (5, 128), (8, 4096)],
                         ids=lambda v: str(v))
def test_cuda_single_edge_sampler_equals_cpu(cuda, k, n):
    """The permutation sampler (one sort round at N = 256, two at 4096)
    draws the same sample sets on the card as on the CPU, bitwise."""
    from repro_torch.runtime.step import sample_fleet
    g = torch.Generator().manual_seed(k * n)
    values = torch.randn(1, k, n, generator=g) * 5.0 + 50.0
    n_real = torch.randint(0, n + 1, (1, k), generator=g, dtype=torch.int32)
    for wid in range(3):
        want = sample_fleet(4, wid, values, n_real)
        got = sample_fleet(4, wid, values.to(cuda), n_real.to(cuda)).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(5, 256), (8, 4096)], ids=lambda v: str(v))
def test_cuda_fleet_kernels_at_one_site_match_plain(cuda, k, n):
    """Both fleet kernels at E = 1, the single-edge scan's shapes: one
    launch each; every output bitwise."""
    g = torch.Generator().manual_seed(k + n)
    x = (torch.randn(1, k, n, generator=g) * 1.5 + 2.0).to(cuda)
    before = ss_ops.LAUNCHES
    mom, xxt = ss_ops.fleet_window_moments_xxt(x)
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == before + 1
    mom_r, xxt_r = fleet_stats_ref(x)
    assert torch.equal(mom, mom_r) and torch.equal(xxt, xxt_r)
    y, u = x[0], torch.randn(k, n, generator=g).to(cuda)
    before = poly_ops.LAUNCHES
    pu, py = poly_ops.vandermonde_moments(y, u)
    torch.cuda.synchronize()
    assert poly_ops.LAUNCHES == before + 1
    pu_r, py_r = polyfit_ref(y, u)
    pu_r[:, 0] = float(n)
    assert torch.equal(pu, pu_r) and torch.equal(py, py_r)


@pytest.mark.cuda
def test_cuda_single_scan_matches_live_reference_bytes(cuda):
    """The single_scan golden on the card, both kernels on: the live JAX
    reference's 4662 WAN bytes (CPU), 2 + 1 launches a window."""
    import json
    import pathlib
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    path = (pathlib.Path(__file__).parent / "goldens" / "scenarios"
            / "single_scan.json")
    sc = ScenarioConfig.from_dict(json.loads(path.read_text())["scenario"])
    before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
    report = Experiment.from_scenario(sc, use_kernel=True,
                                      device=cuda).run()
    assert report.wan_bytes == 4662
    assert (ss_ops.LAUNCHES - before[0], poly_ops.LAUNCHES - before[1]) == (
        6, 3)


# ---- the adaptive drift gate and the golden sweep on the card ------------

def _gate_windows():
    """fleet_scan_adaptive_ph's 12 windows: (T, E, k, N) = (12, 6, 4, 64)."""
    import numpy as np
    from repro_torch.data.streams import fleet_like, fleet_windows
    vals, _ = fleet_like(n_sites=6, n_regions=2, k=4, n_points=768, seed=22,
                         window=64,
                         strength_schedule=[(0, [0.9, 0.2]),
                                            (6, [0.25, 0.85])])
    return np.stack(fleet_windows(vals, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, True])
def test_cuda_gate_matches_cpu(cuda, use_kernel):
    """The drift gate over the adaptive golden's windows, on the card and
    on the CPU: every field bitwise, the EW cross products and the
    correlation the plan assumed included, with the plain versions and
    with the kernel (one launch a window, its Gram in the plain version's
    order)."""
    from repro_torch.adaptive import AdaptiveSpec, gate_init, gate_update
    spec = AdaptiveSpec(detector="page_hinkley", halflife=12.0,
                        ph_delta=0.02, ph_lambda=0.3, min_replan_interval=2)
    wins = torch.as_tensor(_gate_windows())
    t, e, k, n = wins.shape
    counts = torch.full((e, k), n, dtype=torch.int32)
    cpu, card = gate_init(e, k, device="cpu"), gate_init(e, k, device=cuda)
    before = ss_ops.LAUNCHES
    for w in wins:
        cpu, r_cpu = gate_update(spec, cpu, w, counts)
        card, r_card = gate_update(spec, card, w.to(cuda), counts.to(cuda),
                                   use_kernel=use_kernel)
        assert bool(r_cpu) == bool(r_card)
    assert ss_ops.LAUNCHES - before == (t if use_kernel else 0)
    ints = ("det_age", "windows_since", "replans", "reuses", "fires",
            "lag_sum", "lag_events")
    for f in ints:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    fields = [("weight", card.ew.weight, cpu.ew.weight),
              ("s1", card.ew.s1, cpu.ew.s1), ("s2", card.ew.s2, cpu.ew.s2),
              ("xxt", card.ew.xxt, cpu.ew.xxt),
              ("assumed_corr", card.assumed_corr, cpu.assumed_corr),
              ("det_accum", card.det_accum, cpu.det_accum)]
    for name, got, want in fields:
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, None])
def test_cuda_sweep_over_the_committed_reports(cuda, use_kernel):
    """The port's sweep on the card against tests/torch_goldens/reports:
    eight scan goldens (the sharded one at world size 1), no drift (with
    the kernels, the single-edge ones held to the recorded f32 class)."""
    from repro_torch.sweep import runner
    logged = []
    code = runner.run_sweep(pattern="scan", device="cuda",
                            use_kernel=use_kernel, log=logged.append)
    assert code == 0, "\n".join(logged)
    assert "8 scenario(s) checked" in logged[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 2])
def test_cuda_sharded_scan_is_the_scan(cuda, extra):
    """fleet_scan_sharded on the card at world size 1, padded by ``extra``
    dead sites: every byte, budget and NRMSE table and the final state
    bitwise runtime="scan"'s, both kernels launched on every window."""
    import dataclasses
    import json
    import pathlib
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.ckpt import flatten
    path = (pathlib.Path(__file__).parent / "goldens" / "scenarios"
            / "fleet_scan_sharded.json")
    d = json.loads(path.read_text())["scenario"]
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                  use_kernel=True, device=cuda)
    windows = ex.make_windows()
    rt = dataclasses.replace(ex.runtime, pad_sites=ex.runtime.n_sites + extra)
    before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
    got = rt.run(windows)
    t = len(windows)
    assert (ss_ops.LAUNCHES - before[0], poly_ops.LAUNCHES - before[1]) == (
        2 * t, t)
    want = Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(d, runtime="scan")), use_kernel=True,
        device=cuda).runtime.run(windows)
    assert got["wan_bytes"] == want["wan_bytes"]
    for key in ("bytes_history", "budget_history"):
        assert np.array_equal(got[key], want[key]), key
    for q, v in want["site_nrmse"].items():
        assert np.array_equal(got["site_nrmse"][q], v, equal_nan=True), q
    a, b = flatten(got["final_state"]), flatten(want["final_state"])
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key], equal_nan=True), key


# ---- the fleet event loop on the card --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [None, True])
def test_cuda_event_loop_matches_cpu(cuda, use_kernel):
    """fleet_event_batched_rebalance (E = 6, k = 4, N = 64, 6 windows) on
    the card and on the CPU with the same kernel setting: every integer
    counter and the budget history bitwise, and the fleet kernels launched
    once a window each for values and ranks (Spearman), plus polyfit once
    a window with the fused fit."""
    import json
    import pathlib
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    path = (pathlib.Path(__file__).parent / "goldens" / "scenarios"
            / "fleet_event_batched_rebalance.json")
    sc = ScenarioConfig.from_dict(json.loads(path.read_text())["scenario"])
    cpu = Experiment.from_scenario(sc, use_kernel=use_kernel, device="cpu")
    windows = cpu.make_windows()
    r_cpu = cpu.run(windows)
    before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
    r_card = Experiment.from_scenario(sc, use_kernel=use_kernel,
                                      device=cuda).run(windows)
    t = len(windows)
    assert (ss_ops.LAUNCHES - before[0], poly_ops.LAUNCHES - before[1]) == (
        2 * t, t if use_kernel else 0)
    for f in ("wan_bytes", "full_bytes", "gaps", "revisions", "late_drops",
              "duplicates", "retransmits", "plan_windows"):
        assert r_card.raw[f] == r_cpu.raw[f], f
    assert r_card.raw["wan_bytes"] == 10816
    assert np.array_equal(r_card.raw["budget_history"],
                          r_cpu.raw["budget_history"])


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, None, True])
def test_cuda_sweep_over_the_event_goldens(cuda, use_kernel):
    """The six fleet event goldens (the sharded engine's at world size 1)
    on the card against tests/torch_goldens: no drift (on the fused fit's
    path held to the runner's recorded classes and kernel-path reports;
    the host engine's golden runs no kernel, so it is held to its own
    class on both)."""
    from repro_torch.sweep import runner
    logged = []
    code = runner.run_sweep(pattern="fleet_event", device="cuda",
                            use_kernel=use_kernel, log=logged.append)
    assert code == 0, "\n".join(logged)
    assert "6 scenario(s) checked" in logged[-1]


# ---- the host planner and the single-edge event loop on the card -----------

def _single_windows(dataset: str, k_n: tuple, seed: int = 3) -> list:
    """Two windows of a single-edge dataset: full, then with stream 1
    straggled and stream 0 short."""
    import numpy as np
    from repro_torch.api.registry import DATASETS
    import repro_torch.data.streams  # noqa: F401  — fills DATASETS
    k, n = k_n
    kw = {"k": k} if dataset == "turbine" else {}
    vals = np.asarray(DATASETS.get(dataset)(n_points=2 * n, seed=seed,
                                            **kw)[0], np.float32)
    full = np.full(k, n, np.int32)
    short = full.copy()
    short[1], short[0] = 0, n - 37
    return [(vals[:, i * n:(i + 1) * n], c, i)
            for i, c in enumerate((full, short))]


@pytest.mark.cuda
@pytest.mark.parametrize("dataset,k_n", [("smartcity", (5, 256)),
                                         ("home", (3, 256)),
                                         ("turbine", (8, 4096))],
                         ids=lambda v: str(v))
def test_cuda_window_stats_equal_cpu(cuda, dataset, k_n):
    """The host planner's statistics (both dependences) on the card are
    bitwise the CPU's, stragglers and short streams included."""
    from repro_torch.core import stats
    for values, counts, _ in _single_windows(dataset, k_n):
        for dep in ("spearman", "pearson"):
            v, c = torch.as_tensor(values), torch.as_tensor(counts)
            want = stats.window_stats(v, c, dep)
            got = stats.window_stats(v.to(cuda), c.to(cuda), dep)
            for f in ("mean", "var", "m4", "var_of_var", "cov", "corr"):
                t = getattr(got, f)
                assert t.device.type == cuda.type
                assert torch.equal(t.cpu(), getattr(want, f)), (dep, f)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["cubic", "linear", "mean", "multi"])
@pytest.mark.parametrize("dataset,k_n", [("smartcity", (5, 256)),
                                         ("turbine", (8, 4096))],
                         ids=lambda v: str(v))
def test_cuda_host_planner_equals_cpu(cuda, dataset, k_n, family):
    """``plan_window`` with the host planner (the f64 IPM) on the card and
    on the CPU: the payload bitwise (allocations, samples, model, stats
    digest), and no fleet kernel launched."""
    import numpy as np
    from repro_torch.core.planner import plan_window
    from repro_torch.core.types import PlannerConfig, WindowBatch
    cfg = PlannerConfig(model=family, seed=5)
    for values, counts, wid in _single_windows(dataset, k_n):
        batch = WindowBatch.from_numpy(values, counts, wid)
        budget = max(int(0.3 * counts.sum()), 2)
        want, _ = plan_window(batch, budget, cfg, device="cpu")
        before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
        got, diag = plan_window(batch, budget, cfg, device=cuda)
        assert (ss_ops.LAUNCHES, poly_ops.LAUNCHES) == before
        assert diag.device_seconds > 0
        for f in ("n_real", "n_imputed", "predictor"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        for g, w in zip(got.real_values, want.real_values):
            assert np.array_equal(g, w)
        for f in ("mean", "var"):
            assert np.array_equal(got.stats_digest[f], want.stats_digest[f])
        if want.model is not None:
            for f in ("coeffs", "loc", "scale", "explained_var"):
                g = got.model[f] if family == "multi" else \
                    getattr(got.model, f)
                w = want.model[f] if family == "multi" else \
                    getattr(want.model, f)
                assert np.array_equal(np.asarray(g), np.asarray(w)), f


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [None, True])
def test_cuda_sweep_over_the_single_event_goldens(cuda, use_kernel):
    """The seven single-edge event goldens on the card against
    tests/torch_goldens: no drift in their ``exact`` class (the host
    planner and the baselines run no kernel, so the setting changes
    nothing)."""
    from repro_torch.sweep import runner
    logged = []
    before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
    code = runner.run_sweep(pattern="single_event", device="cuda",
                            use_kernel=use_kernel, log=logged.append)
    assert code == 0, "\n".join(logged)
    assert "7 scenario(s) checked" in logged[-1]
    assert (ss_ops.LAUNCHES, poly_ops.LAUNCHES) == before


def _same_payloads(got, want):
    import numpy as np
    for f in ("n_real", "n_imputed", "predictor"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert len(got.real_values) == len(want.real_values)
    for g, w in zip(got.real_values, want.real_values):
        assert np.array_equal(g, w)
    for f in ("mean", "var"):
        assert np.array_equal(got.stats_digest[f], want.stats_digest[f])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["approx_iot", "neyman_cost", "s_voila",
                                    "srs"])
@pytest.mark.parametrize("dataset,k_n", [("smartcity", (5, 256)),
                                         ("turbine", (8, 4096))],
                         ids=lambda v: str(v))
def test_cuda_baseline_planner_equals_cpu(cuda, dataset, k_n, method):
    """``plan_with_baseline`` on the card and on the CPU: the payload
    bitwise (allocations, samples, stats digest), no fleet kernel."""
    from repro_torch.core.planner import plan_with_baseline
    from repro_torch.core.types import WindowBatch
    k = k_n[0]
    cost = tuple(1.0 + 0.5 * (i % 3) for i in range(k))
    for values, counts, wid in _single_windows(dataset, k_n):
        batch = WindowBatch.from_numpy(values, counts, wid)
        budget = max(int(0.26 * counts.sum()), 2)
        want = plan_with_baseline(batch, budget, method, seed=9, cost=cost,
                                  device="cpu")
        before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
        got = plan_with_baseline(batch, budget, method, seed=9, cost=cost,
                                 device=cuda)
        assert (ss_ops.LAUNCHES, poly_ops.LAUNCHES) == before
        _same_payloads(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["thinning", "m_dependence"])
@pytest.mark.parametrize("dataset,k_n", [("smartcity", (5, 256)),
                                         ("turbine", (8, 4096))],
                         ids=lambda v: str(v))
def test_cuda_iid_modes_equal_cpu(cuda, dataset, k_n, mode):
    """The host planner under thinning and m-dependence on the card and on
    the CPU: strides and payload bitwise, no fleet kernel."""
    import numpy as np
    from repro_torch.core.planner import plan_window
    from repro_torch.core.types import PlannerConfig, WindowBatch
    cfg = PlannerConfig(iid_mode=mode, m_lags=2, seed=13)
    for values, counts, wid in _single_windows(dataset, k_n):
        batch = WindowBatch.from_numpy(values, counts, wid)
        budget = max(int(0.3 * counts.sum()), 2)
        want, wdiag = plan_window(batch, budget, cfg, device="cpu")
        before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
        got, gdiag = plan_window(batch, budget, cfg, device=cuda)
        assert (ss_ops.LAUNCHES, poly_ops.LAUNCHES) == before
        _same_payloads(got, want)
        assert (gdiag.strides is None) == (mode == "m_dependence")
        if gdiag.strides is not None:
            assert np.array_equal(gdiag.strides, wdiag.strides)


@pytest.mark.cuda
def test_cuda_host_engine_equals_cpu(cuda):
    """``fleet_event_host_engine`` on the card and on the CPU: every
    counter, the WAN bytes (the live reference's 4796) and every NRMSE
    table bitwise, no fleet kernel."""
    import json
    import pathlib
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    path = (pathlib.Path(__file__).parent / "goldens" / "scenarios"
            / "fleet_event_host_engine.json")
    sc = ScenarioConfig.from_dict(json.loads(path.read_text())["scenario"])
    want = Experiment.from_scenario(sc, device="cpu").run()
    before = (ss_ops.LAUNCHES, poly_ops.LAUNCHES)
    got = Experiment.from_scenario(sc, device=cuda).run()
    assert (ss_ops.LAUNCHES, poly_ops.LAUNCHES) == before
    assert got.wan_bytes == want.wan_bytes == 4796
    for f in ("gaps", "revisions", "late_drops", "duplicates",
              "retransmits"):
        assert getattr(got, f) == getattr(want, f), f
    for q in want.nrmse_per_stream:
        assert np.array_equal(got.nrmse_per_stream[q],
                              want.nrmse_per_stream[q], equal_nan=True), q


# LM serving: the dense decoders' prefill sends self-attention to the flash
# kernels (one launch a layer); decode and the plain route stay torch.  f32:
# the two routes' logits within rtol 1e-3, atol 1e-3 (the model tests' f32
# tolerance: random attention weights magnify the kernel's other summation
# order layer by layer).  bf16: the kernel reads q and k rounded to bf16,
# where the plain route (as the reference) keeps them in f32 after RoPE, so
# the routes' logits part ways at smoke size; there each layer's kernel
# output is held to its plain version on the layer's own q, k, v instead.
LM_ARCHS = ["gemma3-12b", "yi-9b", "starcoder2-3b", "chatglm3-6b"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_prefill_kernel_route_matches_plain(cuda, arch, dtype):
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import layers as lm_layers
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    model = Transformer(cfg, device=cuda, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 40))
    seen = []
    kernel = lm_layers.flash_attention

    def spy(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out
    before = (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES)
    lm_layers.flash_attention = spy
    try:
        got, cache_k = model.prefill({"tokens": toks}, 64)
    finally:
        lm_layers.flash_attention = kernel
    torch.cuda.synchronize()
    sm90 = cfg.n_layers if dtype == "bfloat16" else 0
    assert (fa_ops.LAUNCHES - before[0], fa_ops.SM90_LAUNCHES - before[1]) \
        == (cfg.n_layers, sm90)
    assert len(seen) == cfg.n_layers and torch.isfinite(got).all()
    model.use_kernel = False
    want, cache_p = model.prefill({"tokens": toks}, 64)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES - before[0] == cfg.n_layers
    for a, b in zip(cache_k["layers"], cache_p["layers"]):
        assert torch.equal(a["pos"], b["pos"])
        assert a["write_idx"] == b["write_idx"]
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        return
    for q, k, v, kw, out in seen:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        _assert_bf16_close(out, flash_attention_ref(q, k, v, **kw))


@pytest.mark.cuda
def test_cuda_lm_serve_launches_the_kernel_once_a_layer_per_prefill(cuda):
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.__main__ import PROMPTS
    cfg = get_config("gemma3-12b", smoke=True)
    engine = ServeEngine(None, cfg, batch_slots=4, max_seq=96, device=cuda)
    for i, p in enumerate(PROMPTS):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    before = fa_ops.SM90_LAUNCHES
    done = engine.run()
    torch.cuda.synchronize()
    assert sum(len(r.generated) for r in done) == 72
    # two batches of prompts, one launch a layer each
    assert fa_ops.SM90_LAUNCHES - before == 2 * cfg.n_layers


@pytest.mark.cuda
def test_cuda_lm_prefill_refuses_a_head_dim_the_kernels_lack(cuda):
    """No quiet fallback on the card: hd 24 is not in ``HEAD_DIMS``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True), head_dim=24)
    model = Transformer(cfg, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        model.prefill({"tokens": [[1, 2, 3]]}, 16)


# LM training: a training forward is differentiated, so its attention takes
# the plain route on the card too (the flash kernels have no backward), and
# every leaf gets a gradient.  f32 smoke train steps on the card against the
# same step on the CPU, held to the CPU tests' f32 limits (the train-step
# tests against the reference): the loss within 1e-5 relative, the grad
# norm within 1e-3 relative, every parameter within 2 * lr, each gradient
# leaf within 1e-3 of its largest |grad|, an MoE's routes equal.  gemma3
# smoke's leaves are held to 2e-3: its f32 gradients sit up to 1.66e-3 of
# a leaf's max from the same step in f64 on the CPU alone (the backward of
# layer 1's sliding-window attention, where the probabilities are nearly
# one-hot, multiplies the f32 rounding 3.7-fold; the other families stay
# under 4.7e-4), and the step in f64 on the card equals the CPU's to f64
# rounding, so the card's 1.2-1.3e-3 is f32 order, not a port fault
# (``scripts/lm_grad_probe.py``; ROADMAP queue 3, note m).  The stub
# families' batches carry seeded normal frames or patches.
TRAIN_B, TRAIN_S, TRAIN_LR = 2, 24, 1e-3
STUB_ARCHS = ["whisper-large-v3", "qwen2-vl-2b"]
TRAIN_ARCHS = LM_ARCHS + ["deepseek-moe-16b", "qwen3-moe-30b-a3b",
                          "mamba2-780m", "jamba-1-5-large-398b"] + STUB_ARCHS
TRAIN_GRAD_LIMIT = {"gemma3-12b": 2e-3}


def _train_batch(cfg):
    import numpy as np
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels,
            **random_stub_inputs(cfg, TRAIN_B, rng)}


def _train_state(cfg, device):
    """The same seeded f32 draw on any device: drawn on the CPU, moved."""
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, tree_map
    params = init_params(cfg, torch.Generator().manual_seed(7))
    return adamw_init(tree_map(lambda t: t.to(device), params))


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_a_differentiated_call(cuda):
    q = torch.zeros(1, 64, 4, 64, device=cuda, requires_grad=True)
    k = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, k).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_cuda_lm_train_step_gives_every_leaf_a_gradient(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.optim import cosine_schedule, tree_leaves
    cfg = get_config(arch, smoke=True)                      # bf16
    state = _train_state(cfg, cuda)
    step = make_train_step(cfg, cosine_schedule(TRAIN_LR, 0, 10))
    before = fa_ops.LAUNCHES
    loss, _, grads = step.loss_and_grads(state, _train_batch(cfg))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before            # the plain route
    assert torch.isfinite(loss)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(tree_leaves(state.params))
    for g in leaves:
        assert g.is_cuda and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_cuda_lm_f32_train_step_matches_cpu(cuda, arch):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import cosine_schedule, tree_leaves
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    batch = _train_batch(cfg)
    runs = {}
    dispatch = lm_layers.moe_dispatch
    for dev in ("cpu", cuda):
        routes = []

        def spy(topi, cap):
            routes.append(topi.cpu())
            return dispatch(topi, cap)
        lm_layers.moe_dispatch = spy
        try:
            state = _train_state(cfg, dev)
            step = make_train_step(cfg, cosine_schedule(TRAIN_LR, 0, 10))
            loss, metrics, grads = step.loss_and_grads(state, batch)
        finally:
            lm_layers.moe_dispatch = dispatch
        g = [t.detach().cpu().clone() for t in tree_leaves(grads)]
        state, m = step.apply(state, grads, loss, metrics)
        runs[str(dev)] = (float(m["loss"]), float(m["grad_norm"]), g,
                          [t.detach().cpu() for t in
                           tree_leaves(state.params)], routes)
    (l0, n0, g0, p0, r0), (l1, n1, g1, p1, r1) = (runs["cpu"],
                                                  runs[str(cuda)])
    n_moe = (sum(i % cfg.moe.every == cfg.moe.every - 1
                 for i in range(cfg.n_layers)) if cfg.moe else 0)
    assert len(r0) == len(r1) == 2 * n_moe      # forward and recomputation
    assert all(torch.equal(a, b) for a, b in zip(r1, r0))
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(n1 - n0) <= 1e-3 * n0
    limit = TRAIN_GRAD_LIMIT.get(arch, 1e-3)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max() <= limit * b.abs().max()
    for a, b in zip(p1, p0):
        assert (a - b).abs().max() <= 2 * TRAIN_LR


# MoE (deepseek-moe and qwen3-moe smoke): the layer on the card against the
# same layer on the CPU, routes equal (each token's top-k experts, the
# sort and the clipped ranks) and the output within the f32 tolerance of
# the layer tests (bf16: one bf16 step of the largest output); a prefill
# launches the flash kernel once a layer; the f32 train step as the dense
# families' above
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]


def _moe_routes(params, x, m):
    from repro_torch.models import layers as lm_layers
    t = x.shape[0] * x.shape[1]
    _, probs, _, topi = lm_layers.moe_router(params["router"],
                                             x.reshape(t, -1), m.top_k)
    cap = lm_layers.moe_capacity(t, m)
    return [r.cpu() for r in (topi, *lm_layers.moe_dispatch(topi, cap))]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5],
                         ids=["no-drops", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_layer_matches_cpu_with_equal_routes(cuda, arch, dtype,
                                                      capacity_factor):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as lm_layers
    cfg = get_config(arch, smoke=True)
    m = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    tdt = getattr(torch, dtype)
    params = lm_layers.moe_init(torch.Generator().manual_seed(3),
                                cfg.d_model, m)
    x = torch.randn(3, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).to(tdt)
    on_card = {n: (t.to(cuda) if not isinstance(t, dict) else
                   {a: b.to(cuda) for a, b in t.items()})
               for n, t in params.items()}
    want, want_aux = lm_layers.moe_apply(params, x, m)
    got, got_aux = lm_layers.moe_apply(on_card, x.to(cuda), m)
    for a, b in zip(_moe_routes(on_card, x.to(cuda), m),
                    _moe_routes(params, x, m)):
        assert torch.equal(a, b)
    got = got.cpu()
    assert got.dtype == tdt
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) \
            <= 2.0 ** -7 * scale
    for k in want_aux:
        torch.testing.assert_close(got_aux[k].cpu(), want_aux[k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_prefill_launches_the_kernel_once_a_layer(cuda, arch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    cfg = get_config(arch, smoke=True)                      # bf16
    model = Transformer(cfg, device=cuda, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 40))
    before = fa_ops.SM90_LAUNCHES
    logits, cache = model.prefill({"tokens": toks}, 64)
    torch.cuda.synchronize()
    assert fa_ops.SM90_LAUNCHES - before == cfg.n_layers
    assert torch.isfinite(logits).all()
    logits, _ = model.decode_step(cache, toks[:, :1])
    torch.cuda.synchronize()
    assert fa_ops.SM90_LAUNCHES - before == cfg.n_layers
    assert torch.isfinite(logits).all()


# Mamba2 (mamba2 and jamba smoke): the mixer on the card against the same
# mixer on the CPU, a 64-token prefill (two chunks of 32) with a cache and
# three decode steps: f32 within the MoE layer's card tolerance (rtol
# 1e-4, atol 1e-5), bf16 within one bf16 step of the largest |output|, the
# conv and SSM states handed on likewise; jamba smoke's one attention
# layer takes the tensor-core flash kernel once a prefill, within row 4's
# bf16 tolerance of its plain version on that layer's q, k, v, and decode
# and the Mamba layers launch none.  The f32 train steps are in
# ``TRAIN_ARCHS`` above.
MAMBA_ARCHS = ["mamba2-780m", "jamba-1-5-large-398b"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_cuda_mamba_mixer_matches_cpu(cuda, arch, dtype):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.transformer import init_cache
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              n_layers=len(get_config(arch).pattern))
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    params = lm_layers.mamba_init(gen, cfg)
    params["D"] = torch.randn(params["D"].shape, generator=gen)
    params["conv_b"] = torch.randn(params["conv_b"].shape, generator=gen) / 10
    on_card = {n: (t.to(cuda) if not isinstance(t, dict) else
                   {a: b.to(cuda) for a, b in t.items()})
               for n, t in params.items()}
    xs = [torch.randn(3, n, cfg.d_model, generator=gen).to(tdt)
          for n in (64, 1, 1, 1)]
    caches = {dev: init_cache(cfg, 3, 16, device=dev)["layers"][0]
              for dev in ("cpu", cuda)}

    def close(got, want):
        got = got.cpu()
        assert got.dtype == want.dtype
        if dtype == "float32" or want.dtype == torch.float32:
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-4,
                                       atol=1e-5 if dtype == "float32"
                                       else 2.0 ** -7 * float(
                                           want.abs().max()))
        else:
            assert float((got.float() - want.float()).abs().max()) \
                <= 2.0 ** -7 * float(want.float().abs().max())
    before = fa_ops.LAUNCHES
    for x in xs:
        want, _ = lm_layers.mamba_apply(params, x, cfg, cache=caches["cpu"])
        got, _ = lm_layers.mamba_apply(on_card, x.to(cuda), cfg,
                                       cache=caches[cuda])
        torch.cuda.synchronize()
        close(got, want)
        close(caches[cuda]["conv"], caches["cpu"]["conv"])
        close(caches[cuda]["ssm"], caches["cpu"]["ssm"])
    assert fa_ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_cuda_mamba_prefill_launches_row4_once_per_attention_layer(cuda,
                                                                  arch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import layers as lm_layers
    cfg = get_config(arch, smoke=True)                      # bf16
    model = Transformer(cfg, device=cuda, seed=5)
    n_attn = sum(k != "mamba" for k in cfg.pattern) * cfg.n_blocks
    assert n_attn == (1 if arch.startswith("jamba") else 0)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 40))
    seen = []
    kernel = lm_layers.flash_attention

    def spy(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out
    before = (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES)
    lm_layers.flash_attention = spy
    try:
        logits, cache = model.prefill({"tokens": toks}, 64)
    finally:
        lm_layers.flash_attention = kernel
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES - before[0],
            fa_ops.SM90_LAUNCHES - before[1]) == (n_attn, n_attn)
    assert torch.isfinite(logits).all() and len(seen) == n_attn
    # the kernel against its plain version on the hybrid's own q, k, v
    for q, k, v, kw, out in seen:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        _assert_bf16_close(out, flash_attention_ref(q, k, v, **kw))
    for _ in range(3):
        logits, cache = model.decode_step(cache, toks[:, :1])
    torch.cuda.synchronize()
    assert fa_ops.SM90_LAUNCHES - before[1] == n_attn
    assert torch.isfinite(logits).all() and cache["len"] == 43


# The stub families (whisper smoke: an encoder of 2 layers over 30 frames
# and cross-attention in each of 2 decoder layers; qwen2-vl smoke: 16
# patches before the tokens).  A prefill launches row 4 once in every
# encoder layer (not causal), and twice in every decoder layer: its
# self-attention (causal) and its cross-attention onto the encoder's
# output (not causal, T 30 keys); qwen2-vl once a layer at its own
# positions, never at a caller's (the kernels mask by index).  Each
# kernel output against its plain version on the layer's own q, k, v.
# Row 4 also at whisper-large-v3's full encoder and cross shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["own", "caller"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_cuda_stub_prefill_kernel_route_matches_plain(cuda, arch, dtype,
                                                      positions):
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import layers as lm_layers
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if positions == "caller" and cfg.frontend != "vision_stub":
        pytest.skip("only qwen2-vl takes the caller's positions")
    model = Transformer(cfg, device=cuda, seed=5)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab, (3, 40)),
             **random_stub_inputs(cfg, 3, rng)}
    if positions == "caller":
        n = cfg.n_patches + 40
        batch["positions"] = np.broadcast_to(
            np.minimum(np.arange(n), n - 8)[None, :, None], (3, n, 3)).copy()
    seen = []
    kernel = lm_layers.flash_attention

    def spy(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out
    before = (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES)
    lm_layers.flash_attention = spy
    try:
        got, cache_k = model.prefill(batch, 64)
    finally:
        lm_layers.flash_attention = kernel
    torch.cuda.synchronize()
    n = (cfg.encoder.n_layers + 2 * cfg.n_layers if cfg.encoder is not None
         else cfg.n_layers if positions == "own" else 0)
    assert (fa_ops.LAUNCHES - before[0], fa_ops.SM90_LAUNCHES - before[1]) \
        == (n, n if dtype == "bfloat16" else 0)
    assert len(seen) == n and torch.isfinite(got).all()
    if cfg.encoder is not None:
        # encoder layers, then each decoder layer's self- and cross-step
        want_causal = ([False] * cfg.encoder.n_layers
                       + [True, False] * cfg.n_layers)
        assert [kw["causal"] for *_, kw, _ in seen] == want_causal
        assert all(k.shape[1] == cfg.encoder.seq_len
                   for _, k, _, kw, _ in seen if not kw["causal"])
    model.use_kernel = False
    want, cache_p = model.prefill(batch, 64)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES - before[0] == n
    for a, b in zip(cache_k["layers"], cache_p["layers"]):
        assert torch.equal(a["pos"], b["pos"])
    if dtype == "float32":
        # the layers' own q, k, v give scores of ~100 and outputs of ~10,
        # where the f32 kernel and the plain version each sit some 1e-5
        # from the same attention in f64: the kernel at most twice as far
        # off as the plain version (chip_smoke.py's f32 layer rule)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        for q, k, v, kw, out in seen:
            exact = attention_f64(q, k, v, **kw)
            plain = flash_attention_ref(q, k, v, **kw)
            assert (out.double() - exact).abs().max() \
                <= 2 * (plain.double() - exact).abs().max()
        return
    for q, k, v, kw, out in seen:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        _assert_bf16_close(out, flash_attention_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["encoder", "cross", "self"])
def test_cuda_flash_attention_at_whisper_full_shapes(cuda, case, dtype):
    """whisper-large-v3's encoder self-attention (1500 frames, not causal),
    its cross-attention of a 64-token prompt onto 1500 frames, and its
    decoder's causal self-attention over that prompt, 20 heads of 64,
    batch 2."""
    s, t = {"encoder": (1500, 1500), "cross": (64, 1500),
            "self": (64, 64)}[case]
    causal = case == "self"
    g = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    q = torch.randn(2, s, 20, 64, generator=g).to(cuda, dt)
    k = torch.randn(2, t, 20, 64, generator=g).to(cuda, dt)
    v = torch.randn(2, t, 20, 64, generator=g).to(cuda, dt)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    if dtype == "float32":
        assert (out - want).abs().max() <= FA_ATOL_F32
    else:
        _assert_bf16_close(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_cuda_stub_decode_matches_cpu(cuda, arch):
    """f32 smoke: prefill and 4 greedy decode steps on the card against
    the CPU's (the same f32 draw), tokens equal; whisper's decode steps
    attend to the cached ``enc_out`` on the plain route."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import make_decode_step, make_prefill
    from repro_torch.models import Transformer, init_params
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)),
             **random_stub_inputs(cfg, 2, rng)}
    runs = {}
    for dev in ("cpu", cuda):
        model = Transformer(cfg, params, device=dev)
        prefill, decode = make_prefill(cfg, 32), make_decode_step(cfg)
        logits, cache = prefill(model, batch)
        toks, last = [], [logits.cpu()]
        for _ in range(4):
            nxt = logits[:, -1].argmax(-1)[:, None]
            toks.append(nxt.cpu())
            logits, cache = decode(model, cache, {"tokens": nxt})
            last.append(logits.cpu())
        runs[str(dev)] = (torch.cat(toks, 1), last)
    (t0, l0), (t1, l1) = runs["cpu"], runs[str(cuda)]
    assert torch.equal(t0, t1)
    for a, b in zip(l1, l0):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


# ---- LM sharding: the tensor-parallel prefill on two ranks ------------------

def _tp_prefill(dtype: str, mesh=None) -> dict:
    """gemma3 smoke's prefill on the card (on ``mesh``'s model ranks, or
    unsplit): the last logits, the flash launches (all, tensor-core) and
    each ring's heads."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    cfg = dataclasses.replace(get_config("gemma3-12b", smoke=True),
                              dtype=dtype)
    model = Transformer(cfg, device="cuda", seed=5, mesh=mesh)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 40))
    before = (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES)
    logits, cache = model.prefill({"tokens": toks}, 64)
    torch.cuda.synchronize()
    return {"logits": logits.float().cpu(),
            "launches": (fa_ops.LAUNCHES - before[0],
                         fa_ops.SM90_LAUNCHES - before[1]),
            "ring_heads": {c["k"].shape[2] for c in cache["layers"]},
            "layers": cfg.n_layers, "kv": cfg.n_kv}


def _tp_prefill_rank(rank: int, world: int, tmp: str, backend: str) -> None:
    import datetime
    import pickle
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_local_mesh(model_parallel=world)
        out = {dt: _tp_prefill(dt, mesh) for dt in ("float32", "bfloat16")}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_model_parallel_prefill_on_two_ranks(cuda, tmp_path):
    """Two model ranks (two cards over NCCL, or both on one card over
    gloo): each rank launches the flash kernel once a layer on its heads,
    its rings hold its KV heads, and both ranks' logits are the unsplit
    prefill's: f32 within rtol and atol 1e-3 (the dense prefill's f32
    limit above), bf16 within an RMS of 3e-2 of the unsplit logits' (the
    dense models' bf16 limit, ``tests/test_torch_lm_model.py``)."""
    import pickle
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    mp.start_processes(_tp_prefill_rank, args=(2, str(tmp_path), backend),
                       nprocs=2, join=True, start_method="spawn")
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for dtype in ("float32", "bfloat16"):
        want = _tp_prefill(dtype)
        n = want["layers"]
        assert want["launches"] == (n, n if dtype == "bfloat16" else 0)
        for got in (r[dtype] for r in ranks):
            assert got["launches"] == want["launches"]
            assert got["ring_heads"] == {want["kv"] // 2}
            assert torch.equal(got["logits"], ranks[0][dtype]["logits"])
            if dtype == "float32":
                torch.testing.assert_close(got["logits"], want["logits"],
                                           rtol=1e-3, atol=1e-3)
            else:
                d = got["logits"] - want["logits"]
                assert float(d.square().mean().sqrt()) <= 3e-2 * float(
                    want["logits"].square().mean().sqrt())
