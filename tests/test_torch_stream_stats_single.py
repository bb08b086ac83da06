"""The port's single-window statistics against the JAX package.

On the CPU ``window_moments_xxt`` takes its plain version; the reference
runs its Pallas kernel (``stream_stats_pallas``) in interpret mode.  The
CUDA kernel is held against the plain version on the card by
``test_torch_cuda.py``; here its plan (``ops.window_plan``) is checked, and
a torch emulation of its summation order is held against the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_stats.ops import derived_stats as ref_derived
from repro.kernels.stream_stats.ops import window_moments_xxt as ref_window
from repro_torch.kernels.stream_stats import ops as ss_ops

# the tolerances of tests/test_kernel_stream_stats.py
RTOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATOL = 1e-2
# the shapes of the reference comparison; k = 9, N = 130 is off both the
# tile edges and the 16-byte copies
SHAPES = [(1, 128), (3, 200), (8, 512), (5, 700), (16, 1024), (9, 130)]
WARPS = 10  # csrc/stream_stats.cu: kWarps, the runs of the final sum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_window_moments_match_reference_kernel(k, n, dtype):
    rng = np.random.default_rng(k * 1000 + n)
    x = rng.normal(2.0, 1.5, (k, n)).astype(np.float32)
    mom_r, xxt_r = ref_window(jnp.asarray(x, dtype), use_kernel=True,
                              interpret=True)
    before = ss_ops.WINDOW_LAUNCHES
    mom, xxt = ss_ops.window_moments_xxt(
        torch.as_tensor(x).to(getattr(torch, dtype)))
    assert ss_ops.WINDOW_LAUNCHES == before
    assert mom.dtype == xxt.dtype == torch.float32
    assert mom.shape == (k, 4) and xxt.shape == (k, k)
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_r),
                               rtol=RTOL[dtype], atol=ATOL)
    np.testing.assert_allclose(xxt.numpy(), np.asarray(xxt_r),
                               rtol=RTOL[dtype], atol=ATOL)


@pytest.mark.parametrize("k,n,loc,scale", [(6, 384, 10.0, 4.0),
                                           (3, 100, 0.0, 1.0),
                                           (8, 1, 5.0, 2.0)])
def test_derived_stats_match_reference(k, n, loc, scale):
    rng = np.random.default_rng(k + n)
    x = rng.normal(loc, scale, (k, n)).astype(np.float32)
    mom, xxt = ss_ops.window_moments_xxt(torch.as_tensor(x))
    got = ss_ops.derived_stats(mom, xxt, n)
    want = ref_derived(jnp.asarray(mom.numpy()), jnp.asarray(xxt.numpy()), n)
    # m4 is a difference of terms of size S4 / n that cancel; f32 leaves
    # it a few ulps of that size
    m4_atol = 8 * np.finfo(np.float32).eps * float(mom[:, 3].max()) / n
    for name, g, w in zip(("mean", "var", "m4", "cov"), got, want):
        atol = m4_atol if name == "m4" else 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol, err_msg=name)


def test_window_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.stream_stats_cuda(torch.zeros(3, 40))


def _columns(plan, split):
    """The columns of x that ``split`` of every unit covers (up to the last
    column tile's padding): column tiles split * tps .. of tn columns."""
    lo = split * plan.tps
    return range(lo * plan.tn, min(lo + plan.tps, plan.ncol) * plan.tn)


def _unit_rows(plan, u):
    """(rows of the A side, rows of the B side, diagonal) of unit ``u``, in
    the kernel's order (``unit_of``): the diagonal tiles, then two halves
    of each off-diagonal tile pair ti < tj, row-major."""
    wide = ss_ops.WIDE
    if u < plan.ntiles:
        rows = range(u * wide, u * wide + plan.tile)
        return rows, rows, True
    q, half = divmod(u - plan.ntiles, 2)
    ti = 0
    while q >= plan.ntiles - 1 - ti:
        q -= plan.ntiles - 1 - ti
        ti += 1
    a0 = ti * wide + 32 * half
    b0 = (ti + 1 + q) * wide
    return range(a0, a0 + 32), range(b0, b0 + wide), False


@pytest.mark.parametrize("co_resident", [1, 7, 132, 264])
@pytest.mark.parametrize("k", [1, 3, 9, 64, 65, 130])
def test_window_plan_covers_every_column_and_pair_once(k, co_resident):
    for n in (1, 130, 1000, 4097, 16385):
        for itemsize in (4, 2):
            p = ss_ops.window_plan(k, n, itemsize, co_resident)
            if k <= ss_ops.WIDE:
                assert p.ntiles == 1 and k <= p.tile <= max(8, 2 * k - 1)
            else:
                assert p.tile == ss_ops.WIDE
                assert p.ntiles == -(-k // ss_ops.WIDE)
            # a slot holds the tile's upper triangle in 8 x 8 blocks and
            # its power sums, and half an off-diagonal tile pair
            nb = p.tile // 8
            assert p.zslot == 64 * nb * (nb + 1) // 2 + 32 * nb
            assert p.zslot >= (32 * ss_ops.WIDE if p.ntiles > 1 else 0)
            assert p.tile in (8, 16, 32, 64)
            assert p.tn >= 64 and p.tn & (p.tn - 1) == 0
            assert p.tn <= ss_ops.tile_cols(p.tile)
            # column tiles: the splits take every column once, in order,
            # none of them empty
            assert (p.ncol - 1) * p.tn < n <= p.ncol * p.tn
            cols = [c for sp in range(p.splits) for c in _columns(p, sp)]
            assert cols == list(range(p.ncol * p.tn))
            assert all(len(_columns(p, sp)) > 0 for sp in range(p.splits))
            assert 1 <= p.grid <= min(co_resident, p.items)
            assert p.items == p.units * p.splits
            # every item, one included, has its slot in the workspace
            assert p.workspace == p.items * p.zslot
        # units: every Gram entry i <= j of the window once
        seen = np.zeros((k, k), np.int64)
        for u in range(p.units):
            ra, rb, diag = _unit_rows(p, u)
            for i in ra:
                for j in rb:
                    if i < k and j < k and (not diag or i <= j):
                        seen[i, j] += 1
        assert (np.triu(seen) == np.triu(np.ones((k, k), np.int64))).all()
        assert not np.tril(seen, -1).any()


def _kernel_order(x: torch.Tensor, plan):
    """The kernel's sums in torch: f32 partials of each split over its
    columns, the splits added in runs of ``WARPS`` (each run in split
    order, the runs in order), the upper triangle mirrored and S2 taken
    from the Gram's diagonal."""
    x = x.to(torch.float32)
    n = x.shape[1]
    parts = []
    for sp in range(plan.splits):
        c = _columns(plan, sp)
        xs = x[:, c.start:min(c.stop, n)]
        g = xs @ xs.T
        x2 = xs * xs
        parts.append((torch.stack([xs.sum(1), torch.diagonal(g),
                                   (x2 * xs).sum(1), (x2 * x2).sum(1)], 1),
                      torch.triu(g)))
    runs = []
    for w in range(WARPS):
        lo, hi = w * plan.splits // WARPS, (w + 1) * plan.splits // WARPS
        mom = torch.zeros_like(parts[0][0])
        tri = torch.zeros_like(parts[0][1])
        for m, t in parts[lo:hi]:
            mom, tri = mom + m, tri + t
        runs.append((mom, tri))
    mom, tri = runs[0]
    for m, t in runs[1:]:
        mom, tri = mom + m, tri + t
    return mom, tri + torch.triu(tri, 1).T


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_kernel_order_emulation_matches_reference_kernel(k, n, dtype):
    rng = np.random.default_rng(k * 1000 + n + 1)
    x = rng.normal(2.0, 1.5, (k, n)).astype(np.float32)
    mom_r, xxt_r = ref_window(jnp.asarray(x, dtype), use_kernel=True,
                              interpret=True)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    plan = ss_ops.window_plan(k, n, xt.element_size(), 132)
    mom, xxt = _kernel_order(xt, plan)
    assert torch.equal(xxt, xxt.T)
    assert torch.equal(mom[:, 1], torch.diagonal(xxt))
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_r),
                               rtol=RTOL[dtype], atol=ATOL)
    np.testing.assert_allclose(xxt.numpy(), np.asarray(xxt_r),
                               rtol=RTOL[dtype], atol=ATOL)
