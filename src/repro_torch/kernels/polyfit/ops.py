"""Vandermonde moments for the compact-model fits: the CUDA kernel's
wrapper, the m=0 count fix-up and the 4x4 normal-equation solve.

Port of ``repro.kernels.polyfit.ops``.  A CPU tensor always takes the
plain version (:mod:`.ref`); a CUDA tensor launches the hand-written
kernel (``csrc/polyfit.cu``) unless the caller passes ``use_kernel=False``.
A failed build or launch raises.  The kernel forms the plain version's
products and sums them in its order, so the two agree bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.stats import lu_solve4
from repro_torch.kernels import build
from repro_torch.kernels.polyfit.ref import polyfit_ref

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def polyfit_cuda(y: torch.Tensor, u: torch.Tensor):
    """Launch the kernel on contiguous (R, N) f32 CUDA tensors.

    Returns (pu (R, 7), py (R, 4)) with pu[:, 0] = N.
    """
    global LAUNCHES
    for name, t in (("y", y), ("u", u)):
        if not t.is_cuda:
            raise ValueError(f"polyfit needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"polyfit needs float32, {name} is {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"polyfit needs contiguous (R, N) tensors, "
                             f"{name} has shape {tuple(t.shape)}, "
                             f"contiguous={t.is_contiguous()}")
    if y.shape != u.shape or y.device != u.device:
        raise ValueError(f"polyfit: y {tuple(y.shape)} on {y.device} and "
                         f"u {tuple(u.shape)} on {u.device} must match")
    rows, n = y.shape
    pu = torch.empty((rows, 7), dtype=torch.float32, device=y.device)
    py = torch.empty((rows, 4), dtype=torch.float32, device=y.device)
    if rows == 0 or n == 0:
        return pu.zero_(), py.zero_()
    fn = build.load("polyfit_moments", _ARGTYPES)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = fn(y.data_ptr(), u.data_ptr(), pu.data_ptr(), py.data_ptr(),
                rows, n, stream)
    build.check("polyfit_moments", rc)
    LAUNCHES += 1
    return pu, py


def vandermonde_moments(y: torch.Tensor, u: torch.Tensor, use_kernel=True,
                        counts=None):
    """Vandermonde power sums for E[y|u] polynomial fits, rows (R, N).

    The m=0 column is the count: N, or the caller's per-row ``counts``
    (R,).  With y and u pre-multiplied by a 0/1 mask w, ``(u*w)**m ==
    (u**m)*w`` for m >= 1, so every higher moment is already the masked
    sum and only the m=0 column needs the true count.
    """
    n = y.shape[-1]
    if y.is_cuda and use_kernel is not False:
        pu, py = polyfit_cuda(y, u)
    else:
        pu, py = polyfit_ref(y, u)
    # pu is a fresh tensor on both paths, so the fix-up writes in place
    if counts is None:
        pu[:, 0] = float(n)
    else:
        pu[:, 0] = counts.to(pu.dtype)
    return pu, py


def solve_normal_equations(pu: torch.Tensor, py: torch.Tensor,
                           degree: int = 3, ridge: float = 1e-6):
    """(..., 7), (..., 4) -> coeffs (..., 4) of c0 + c1 u + c2 u^2 + c3 u^3.

    Degrees above ``degree`` are forced to zero by masking the Gram
    matrix; one batched 4x4 solve in LAPACK's order
    (:func:`~repro_torch.core.stats.lu_solve4`), the same on the card as
    on the CPU.
    """
    idx = torch.arange(4, device=pu.device)
    gram = pu[..., idx[:, None] + idx[None, :]]        # (..., 4, 4) Hankel
    keep = (idx <= degree).to(pu.dtype)
    mask = keep[:, None] * keep[None, :]
    eye = torch.eye(4, dtype=pu.dtype, device=pu.device)
    gram = (gram * mask
            + (1.0 - mask) * eye * torch.clamp(pu[..., 0:1, None], min=1.0))
    gram = gram + ridge * eye
    rhs = py * keep
    return lu_solve4(gram, rhs)
