"""Fleet window statistics: the CUDA kernel's wrapper and its dispatch.

``fleet_window_moments_xxt`` is the port of
``repro.kernels.stream_stats.ops.fleet_window_moments_xxt``.  A CPU tensor
always takes the plain version (:mod:`.ref`); a CUDA tensor launches the
hand-written kernel (``csrc/stream_stats_fleet.cu``) unless the caller
passes ``use_kernel=False``.  A failed build or launch raises.  The
kernel takes the power sums in the plain version's order, so they are
bitwise the plain version's; the Gram block agrees to f32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream_stats.ref import fleet_stats_ref

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
