"""Window statistics: the CUDA kernels' wrappers, their dispatch and the
derived statistics.

Port of ``repro.kernels.stream_stats.ops``.  ``fleet_window_moments_xxt``
(a whole fleet, per-site Gram blocks, ``csrc/stream_stats_fleet.cu``) and
``window_moments_xxt`` (one window, the full Gram matrix,
``csrc/stream_stats.cu``) take the plain version (:mod:`.ref`) for a CPU
tensor and launch their hand-written kernel for a CUDA tensor unless the
caller passes ``use_kernel=False``.  A failed build or launch raises.
The fleet kernel takes the power sums in the plain version's order, so
they are bitwise the plain version's; every other sum agrees to f32
rounding.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream_stats.ref import (fleet_stats_ref,
                                                  stream_stats_ref)

# launches of each CUDA kernel, counted where its wrapper launches it:
# LAUNCHES for stream_stats_fleet, WINDOW_LAUNCHES for stream_stats
LAUNCHES = 0
WINDOW_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_WINDOW_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    *[ctypes.c_int] * 7, ctypes.c_void_p]


def stream_stats_fleet_cuda(x: torch.Tensor):
    """Launch the kernel on a contiguous (E, k, N) f32 CUDA tensor.

    Returns (moments (E, k, 4), xxt (E, k, k)), f32, on ``x``'s device.
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"stream_stats_fleet needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stream_stats_fleet needs float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"stream_stats_fleet needs a contiguous (E, k, N) "
                         f"tensor, got shape {tuple(x.shape)}, contiguous="
                         f"{x.is_contiguous()}")
    e, k, n = x.shape
    if not 1 <= k <= 64:
        raise ValueError(f"stream_stats_fleet supports 1 <= k <= 64, got {k}")
    mom = torch.empty((e, k, 4), dtype=torch.float32, device=x.device)
    xxt = torch.empty((e, k, k), dtype=torch.float32, device=x.device)
    if e == 0 or n == 0:
        return mom.zero_(), xxt.zero_()
    fn = build.load("stream_stats_fleet", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mom.data_ptr(), xxt.data_ptr(), e, k, n, stream)
    build.check("stream_stats_fleet", rc)
    LAUNCHES += 1
    return mom, xxt


def fleet_window_moments_xxt(x: torch.Tensor, use_kernel=None):
    """Raw power sums + per-site cross products for a fleet (E, k, N).

    Returns (moments (E, k, 4), xxt (E, k, k)), both f32.  ``use_kernel``
    None or True launches the CUDA kernel for a CUDA tensor; False keeps
    the plain version everywhere.  A CPU tensor takes the plain version.
    """
    if x.is_cuda and use_kernel is not False:
        return stream_stats_fleet_cuda(x)
    return fleet_stats_ref(x)


# the one-window kernel's plan (csrc/stream_stats.cu): row tiles above
# k = 64, and the least bytes of x a block should take before the window
# is cut into more blocks (2 KB beat 4, 8 and 16 KB at (8, 4096) f32 on
# an H100; PERF.md, row 3's findings)
WIDE = 64
BLOCK_BYTES = 2048


def tile_cols(tile: int) -> int:
    """The widest column tile at tile edge ``tile`` (``tile_cols`` in
    csrc/stream_stats.cu)."""
    return 256 if tile == WIDE else 8192 // tile


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """How the one-window kernel cuts a (k, N) window: row tiles of
    ``tile`` (``ntiles`` of 64 above k = 64, giving ``ntiles ** 2`` units:
    the diagonal tiles and two halves of each off-diagonal tile pair),
    column tiles of ``tn`` columns, and for each unit ``splits`` runs of
    ``tps`` column tiles, one work item each, on a grid of ``grid`` blocks.
    """
    tile: int
    ntiles: int
    tn: int
    ncol: int
    splits: int
    tps: int
    grid: int

    @property
    def units(self) -> int:
        return self.ntiles * self.ntiles

    @property
    def items(self) -> int:
        return self.units * self.splits

    @property
    def workspace(self) -> int:
        """Floats of the workspace: a slot for every item."""
        return self.items * self.zslot

    @property
    def zslot(self) -> int:
        """Floats of an item's workspace slot: 64 for each of the tile's
        nb(nb + 1) / 2 row-block pairs and 32 power sums for each of its
        nb row blocks (nb = tile / 8)."""
        nb = self.tile // 8
        return 32 * nb * (nb + 1) + 32 * nb


def window_plan(k: int, n: int, itemsize: int, co_resident: int) -> WindowPlan:
    """The plan for x (k, n) of ``itemsize``-byte elements on a card that
    holds ``co_resident`` blocks of the kernel at once.

    Each unit is cut into about one split per ``BLOCK_BYTES`` of its rows,
    at most its share of the co-resident blocks rounded down to a power of
    two (so that a window of power-of-two width splits into whole column
    tiles); the column tiles are the widest power of two (64 up to
    ``tile_cols``) that still give every split one.  The grid is at most
    ``co_resident`` (a cooperative launch needs every block resident) and
    at most the items.
    """
    ntiles = -(-k // WIDE) if k > WIDE else 1
    tile = WIDE if ntiles > 1 else max(8, 1 << (k - 1).bit_length())
    rows = 32 + WIDE if ntiles > 1 else tile       # staged rows of a unit
    units = ntiles * ntiles
    share = co_resident // units
    want = max(1, min(1 << (share.bit_length() - 1) if share else 1,
                      -(-rows * n * itemsize // BLOCK_BYTES)))
    tn = 64
    while tn * 2 <= tile_cols(tile) and -(-n // (tn * 2)) >= want:
        tn *= 2
    ncol = -(-n // tn)
    tps = -(-ncol // min(want, ncol))
    splits = -(-ncol // tps)
    return WindowPlan(tile=tile, ntiles=ntiles, tn=tn, ncol=ncol,
                      splits=splits, tps=tps,
                      grid=min(co_resident, units * splits))


@functools.cache
def _window_fns():
    """The kernel's entry point, its occupancy query and the current
    stream's handle of a device, bound once.  PyTorch's raw-handle query
    skips the Stream object ``torch.cuda.current_stream`` builds, several
    microseconds of host time a call."""
    fn = build.load("stream_stats", _WINDOW_ARGTYPES)
    blocks = build.library("stream_stats").stream_stats_blocks_per_sm
    blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
    blocks.restype = ctypes.c_int
    return fn, blocks, torch._C._cuda_getCurrentRawStream


@functools.cache
def _co_resident(index: int, tile: int, dtype_code: int) -> int:
    """Blocks of the tile's kernel that fit on card ``index`` at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _window_fns()[1](tile, dtype_code, ctypes.byref(per_sm))
    build.check("stream_stats", rc)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(1, per_sm.value) * sms


@functools.lru_cache(maxsize=256)
def _device_plan(k: int, n: int, dtype: torch.dtype, index: int):
    tile = window_plan(k, n, dtype.itemsize, 1).tile
    return window_plan(k, n, dtype.itemsize,
                       _co_resident(index, tile, build.DTYPE_CODES[dtype]))


def stream_stats_cuda(x: torch.Tensor):
    """Launch the kernel on a contiguous (k, N) f32 or bf16 CUDA tensor.

    Returns (moments (k, 4), xxt (k, k)), f32, on ``x``'s device: views of
    one buffer that also holds the kernel's workspace (one allocation a
    call).  A result that is kept keeps that buffer too (the workspace is
    ``WindowPlan.workspace`` floats, 1.3 MB at (64, 262144)), and
    ``torch.save`` of a view writes all of it: ``.clone()`` a result to
    keep only its own floats.  One launch a call; two launches on the same input give
    bitwise equal results.
    """
    global WINDOW_LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"stream_stats needs a CUDA tensor, got {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"stream_stats needs float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"stream_stats needs a contiguous (k, N) tensor, "
                         f"got shape {tuple(x.shape)}, contiguous="
                         f"{x.is_contiguous()}")
    k, n = x.shape
    if k == 0 or n == 0:
        return (torch.zeros((k, 4), dtype=torch.float32, device=x.device),
                torch.zeros((k, k), dtype=torch.float32, device=x.device))
    device = x.device
    index = device.index
    p = _device_plan(k, n, x.dtype, index)
    # mom, xxt, then the workspace from the next multiple of 8 floats
    out = torch.empty((4 * k + k * k + 7) // 8 * 8 + p.workspace,
                      dtype=torch.float32, device=device)
    args = (x.data_ptr(), build.DTYPE_CODES[x.dtype], out.data_ptr(), k, n,
            p.tile, p.tn.bit_length() - 1, p.splits, p.tps, p.grid)
    fn, _, stream = _window_fns()
    if index == torch.cuda.current_device():
        rc = fn(*args, stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream(index))
    build.check("stream_stats", rc)
    WINDOW_LAUNCHES += 1
    return (out.as_strided((k, 4), (4, 1)),
            out.as_strided((k, k), (k, 1), 4 * k))


def window_moments_xxt(x: torch.Tensor, use_kernel=True):
    """Raw power sums + cross products of a full window (k, N).

    Returns (moments (k, 4) [S1..S4], xxt (k, k)), both f32.  A CUDA
    tensor launches the kernel unless ``use_kernel`` is False; a CPU tensor
    takes the plain version.  The kernel needs no padding: it masks the
    ragged edges of k and N itself.
    """
    if x.is_cuda and use_kernel is not False:
        return stream_stats_cuda(x)
    return stream_stats_ref(x)


def derived_stats(mom: torch.Tensor, xxt: torch.Tensor, n: int):
    """(S1..S4, XXt, N) -> mean, var (unbiased), m4, cov (unbiased).

    Counterpart of ``repro.kernels.stream_stats.ops.derived_stats``: the
    reference's masked moments and covariance for full windows.
    """
    nf = torch.tensor(float(n), dtype=torch.float32, device=mom.device)
    s1, s2, s3, s4 = mom[:, 0], mom[:, 1], mom[:, 2], mom[:, 3]
    mean = s1 / nf
    m2 = s2 / nf - mean**2
    var = m2 * nf / torch.clamp(nf - 1.0, min=1.0)
    m4 = (s4 - 4 * mean * s3 + 6 * mean**2 * s2 - 3 * mean**4 * nf) / nf
    cov = (xxt / nf - mean[:, None] * mean[None, :]) \
        * nf / torch.clamp(nf - 1.0, min=1.0)
    return mean, var, torch.clamp(m4, min=0.0), cov
