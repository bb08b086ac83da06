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
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]


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


@functools.cache
def _stream_stats_fns():
    """The kernel's entry point and its workspace size (floats for (k, N)),
    bound once."""
    fn = build.load("stream_stats", _WINDOW_ARGTYPES)
    workspace = build.library("stream_stats").stream_stats_workspace
    workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    workspace.restype = ctypes.c_longlong
    return fn, workspace


def stream_stats_cuda(x: torch.Tensor):
    """Launch the kernel on a contiguous (k, N) f32 or bf16 CUDA tensor.

    Returns (moments (k, 4), xxt (k, k)), f32, on ``x``'s device.  Two
    launches on the same input give bitwise equal results.
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
    mom = torch.empty((k, 4), dtype=torch.float32, device=x.device)
    xxt = torch.empty((k, k), dtype=torch.float32, device=x.device)
    if k == 0 or n == 0:
        return mom.zero_(), xxt.zero_()
    fn, workspace = _stream_stats_fns()
    ws = torch.empty(workspace(k, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), build.DTYPE_CODES[x.dtype], mom.data_ptr(),
                xxt.data_ptr(), ws.data_ptr(), k, n, stream)
    build.check("stream_stats", rc)
    WINDOW_LAUNCHES += 1
    return mom, xxt


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
