"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one; on the card
run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels.polyfit import ops as poly_ops
from repro_torch.kernels.polyfit.ref import polyfit_ref
from repro_torch.kernels.stream_stats import ops as ss_ops
from repro_torch.kernels.stream_stats.ref import fleet_stats_ref

# the Gram block's tolerance, as in tests/test_kernel_stream_stats.py
SS_RTOL, SS_ATOL = 2e-5, 1e-2

FLEET_SHAPES = [(1024, 8, 256), (3, 5, 200), (6, 4, 64), (2, 8, 512),
                (4, 9, 130), (2, 3, 20), (2, 16, 1500)]


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
                                    (3, 20), (2, 1500)])
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
