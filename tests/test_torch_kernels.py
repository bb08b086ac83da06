"""The port's kernel modules against the JAX package on the same inputs.

On the CPU the port's wrappers take their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode (and its jnp oracle
with ``use_kernel=False``).  The CUDA kernels themselves are held against
the plain versions on the card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.polyfit.ops import (solve_normal_equations as ref_solve,
                                       vandermonde_moments as ref_vm)
from repro.kernels.stream_stats.ops import \
    fleet_window_moments_xxt as ref_fleet_moments
from repro_torch.kernels import build
from repro_torch.kernels.polyfit import ops as poly_ops
from repro_torch.kernels.polyfit.ref import polyfit_ref
from repro_torch.kernels.stream_stats import ops as ss_ops
from repro_torch.kernels.stream_stats.ref import fleet_stats_ref

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

# tolerances of tests/test_kernel_stream_stats.py and test_kernel_polyfit.py
SS_RTOL, SS_ATOL = 2e-5, 1e-2
PF_RTOL, PF_ATOL = 1e-4, 0.5

FLEET_SHAPES = [(3, 5, 200), (6, 4, 64), (2, 8, 512), (4, 9, 130)]


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "jnp_oracle"])
@pytest.mark.parametrize("shape", FLEET_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fleet_moments_match_reference(shape, interpret):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(2.0, 1.5, shape).astype(np.float32)
    mom_r, xxt_r = ref_fleet_moments(jnp.asarray(x), use_kernel=interpret,
                                     interpret=interpret)
    mom, xxt = ss_ops.fleet_window_moments_xxt(torch.as_tensor(x))
    assert mom.shape == shape[:2] + (4,) and xxt.shape == shape[:2] + shape[1:2]
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_r), rtol=SS_RTOL,
                               atol=SS_ATOL)
    np.testing.assert_allclose(xxt.numpy(), np.asarray(xxt_r), rtol=SS_RTOL,
                               atol=SS_ATOL)


def test_fleet_power_sums_are_bitwise_the_reference_oracle():
    """The plain version sums in XLA:CPU's order, so the power sums (which
    the k-SE epsilon amplifies) are bitwise the reference's."""
    rng = np.random.default_rng(7)
    x = rng.normal(50.0, 10.0, (6, 4, 256)).astype(np.float32)
    mom_r, _ = ref_fleet_moments(jnp.asarray(x), use_kernel=False)
    mom, _ = fleet_stats_ref(torch.as_tensor(x))
    np.testing.assert_array_equal(mom.numpy(), np.asarray(mom_r))


@pytest.mark.parametrize("with_counts", [False, True],
                         ids=["count_N", "masked_counts"])
@pytest.mark.parametrize("k,n", [(1, 128), (4, 300), (8, 512), (11, 900)])
def test_vandermonde_moments_match_reference(k, n, with_counts):
    rng = np.random.default_rng(k + n)
    y = rng.normal(0, 1, (k, n)).astype(np.float32)
    u = rng.normal(0, 1, (k, n)).astype(np.float32)
    counts = None
    if with_counts:
        w = (rng.random((k, n)) < 0.7).astype(np.float32)
        y, u = y * w, u * w
        counts = w.sum(-1)
    pu_r, py_r = ref_vm(jnp.asarray(y), jnp.asarray(u), use_kernel=True,
                        interpret=True,
                        counts=None if counts is None else jnp.asarray(counts))
    pu, py = poly_ops.vandermonde_moments(
        torch.as_tensor(y), torch.as_tensor(u),
        counts=None if counts is None else torch.as_tensor(counts))
    np.testing.assert_allclose(pu.numpy(), np.asarray(pu_r), rtol=PF_RTOL,
                               atol=PF_ATOL)
    np.testing.assert_allclose(py.numpy(), np.asarray(py_r), rtol=PF_RTOL,
                               atol=PF_ATOL)
    want0 = np.full(k, n, np.float32) if counts is None else counts
    np.testing.assert_array_equal(pu.numpy()[:, 0], want0)


@pytest.mark.parametrize("degree", [1, 3])
def test_solve_normal_equations_matches_reference(degree):
    rng = np.random.default_rng(degree)
    u = rng.normal(0, 1, (5, 400)).astype(np.float32)
    y = (1.0 - 2.0 * u + 0.3 * u**2 - 0.1 * u**3
         + rng.normal(0, 0.1, u.shape)).astype(np.float32)
    pu, py = poly_ops.vandermonde_moments(torch.as_tensor(y),
                                          torch.as_tensor(u))
    c = poly_ops.solve_normal_equations(pu, py, degree=degree)
    c_r = ref_solve(jnp.asarray(pu.numpy()), jnp.asarray(py.numpy()),
                    degree=degree)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_r), rtol=1e-4,
                               atol=1e-5)


def test_kernel_modules_import_and_dispatch_without_nvcc():
    """A CPU tensor takes the plain version without building or launching
    anything, and the CUDA entry points refuse it."""
    x = torch.zeros(2, 3, 40)
    before = ss_ops.LAUNCHES
    mom, xxt = ss_ops.fleet_window_moments_xxt(x, use_kernel=True)
    assert mom.shape == (2, 3, 4) and xxt.shape == (2, 3, 3)
    assert ss_ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.stream_stats_fleet_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        poly_ops.polyfit_cuda(x[0], x[0])
    assert build.lib_path("polyfit_moments").suffix == ".so"


@pytest.mark.parametrize("n,same", [(64, True), (256, True), (100, False)])
def test_reference_kernel_order_differs_from_its_oracle_off_32(n, same):
    """ROADMAP queue 3, note d: the reference's Pallas kernel sums in
    tn-wide tiles padded at the high end, its jnp oracle in 32-wide windows
    padded at both ends.  The two agree bitwise when N is a multiple of 32
    and not otherwise; the port's plain version follows the oracle."""
    rng = np.random.default_rng(n)
    x = rng.normal(50.0, 10.0, (3, 4, n)).astype(np.float32)
    mom_k, _ = ref_fleet_moments(jnp.asarray(x), use_kernel=True,
                                 interpret=True)
    mom_o, _ = ref_fleet_moments(jnp.asarray(x), use_kernel=False)
    assert np.array_equal(np.asarray(mom_k), np.asarray(mom_o)) == same
    mom, _ = fleet_stats_ref(torch.as_tensor(x))
    np.testing.assert_array_equal(mom.numpy(), np.asarray(mom_o))


# The fleet path's CUDA kernels (csrc/window_tiles.cuh, stream_stats_fleet.cu,
# polyfit.cu), emulated in plain torch: the copy of a tile of windows into
# the window-major layout of pitch 36 (windows starting lo zeros before
# column 0), the left-to-right sum of each staged window, and the second
# level of blocked_sum streamed across chunks of nwc windows.  Positions the
# copy never writes hold NaN, so a read of one shows in the result.  Held
# bitwise against the plain versions, this catches an index error before
# the kernels reach the card.
WIN, PITCH = 32, 36


def _windows(n):
    nwin = -(-n // WIN)
    nw2 = -(-nwin // WIN)
    lo2 = (nw2 * WIN - nwin) // 2 if nwin > WIN else 0
    return nwin, (nwin * WIN - n) // 2, lo2


def _stage(x, w0, nw, nwc, lo):
    """load_tile: windows w0 .. w0 + nw - 1 of the rows of x, one quad of
    four columns per copy."""
    rows, n = x.shape
    flat = torch.full((rows * nwc * PITCH,), float("nan"))
    q = np.arange(rows * nw * (WIN // 4))
    jq, t = q & 7, q >> 3
    r, w = t // nw, t % nw
    for i in range(4):
        c = (w0 + w) * WIN + 4 * jq - lo + i
        ok = (c >= 0) & (c < n)
        vals = torch.zeros(len(q))
        vals[torch.as_tensor(ok)] = x[r[ok], c[ok]]
        flat[(r * nwc + w) * PITCH + 4 * jq + i] = vals
    return flat


def _emulated_sums(xs, terms, nwc):
    """Per-row sums of each of ``terms(*staged values)``, the kernels' way:
    rows of every array in ``xs`` (R, N), chunks of ``nwc`` windows (the
    whole row if None)."""
    rows, n = xs[0].shape
    nwin, lo, lo2 = _windows(n)
    nwc = nwin if nwc is None else nwc
    cur = tot = None
    for w0 in range(0, nwin, nwc):
        nw = min(nwc, nwin - w0)
        tiles = [_stage(x, w0, nw, nwc, lo) for x in xs]
        base = torch.as_tensor((np.arange(rows)[:, None] * nwc
                                + np.arange(nw)[None, :]) * PITCH)
        sums = None
        for j in range(WIN):
            vals = torch.stack(terms(*(t[base + j] for t in tiles)))
            sums = vals if sums is None else sums + vals   # (M, R, nw)
        if cur is None:
            cur = tot = torch.zeros(sums.shape[:2])
        big = 0 if w0 == 0 else (w0 - 1 + lo2) >> 5
        for w in range(nw):
            b = (w0 + w + lo2) >> 5
            if b != big:
                tot, cur, big = tot + cur, torch.zeros_like(cur), b
            cur = cur + sums[:, :, w]
    return (tot + cur).T                                      # (R, M)


def _fleet_terms(v):
    v2 = v * v
    return [v, v2, v2 * v, v2 * v2]


def _polyfit_terms(y, u):
    u2 = u * u
    u3, u4 = u * u2, u2 * u2
    return [u, u2, u3, u4, u * u4, u2 * u4, y, y * u, y * u2, y * u3]


# chunk widths: the whole row, stream_stats_fleet's at k = 8 and N = 1500
# (a chunk ends inside the second window of window sums), and 4 (k = 64)
EMULATED_NWC = [None, 35, 4]


@pytest.mark.parametrize("nwc", EMULATED_NWC, ids=lambda c: f"nwc{c}")
@pytest.mark.parametrize("n", [20, 130, 200, 256, 1500])
def test_fleet_kernel_staging_emulation_is_bitwise_the_plain_version(n, nwc):
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(50.0, 10.0, (2, 3, n)).astype(np.float32))
    got = _emulated_sums([x.reshape(6, n)], _fleet_terms, nwc)
    mom, _ = fleet_stats_ref(x)
    assert torch.equal(got, mom.reshape(6, 4))


@pytest.mark.parametrize("nwc", EMULATED_NWC, ids=lambda c: f"nwc{c}")
@pytest.mark.parametrize("n", [20, 130, 200, 256, 1500])
def test_polyfit_kernel_staging_emulation_is_bitwise_the_plain_version(n,
                                                                       nwc):
    rng = np.random.default_rng(n + 1)
    y = torch.as_tensor(rng.normal(0.0, 2.0, (5, n)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0.0, 1.0, (5, n)).astype(np.float32))
    got = _emulated_sums([y, u], _polyfit_terms, nwc)
    pu, py = polyfit_ref(y, u)
    assert torch.equal(got, torch.cat([pu[:, 1:], py], dim=1))
