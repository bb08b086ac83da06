"""Flash attention: the CUDA kernels' wrapper and its dispatch.

Port of ``repro.kernels.flash_attention.ops``.  A CPU tensor takes the
plain version (:mod:`.ref`); a CUDA tensor launches a hand-written kernel
unless the caller passes ``use_kernel=False``: bf16 goes to the
tensor-core kernel (``csrc/flash_attention_sm90.cu``: wgmma, TMA), f32 to
the CUDA-core kernel (``csrc/flash_attention.cu``: f32 FFMA in register
tiles, K and V tiles through a two-slot cp.async ring).  A failed build
or launch raises, and so does a call the kernel of its type cannot take.
The kernels mask ragged S and T themselves, so nothing is padded or
sliced here.  Query rows with no live key (``window`` > 0 and
S >= T + window) get the plain version's answer, the mean of v over all T
keys: where the shape has such rows, the wrapper first launches a small
reduction (``attn_v_mean`` in ``csrc/flash_attention.cu``) whose f32 means
both kernels write to those rows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# launches of either CUDA kernel, counted where the wrapper launches it
LAUNCHES = 0
# launches of the tensor-core (bf16) kernel alone
SM90_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 240)   # both kernels' instantiations

# q, k, v, o, v's means (or None), then the ints and the stream
_ARGTYPES = [*[ctypes.c_void_p] * 5, *[ctypes.c_int] * 9, ctypes.c_void_p]
_SM90_ARGTYPES = [*[ctypes.c_void_p] * 5, *[ctypes.c_int] * 8,
                  ctypes.c_void_p]


@functools.cache
def _v_mean_fn():
    """``flash_attention_v_mean`` of the f32 kernel's library, bound once."""
    fn = build.library("flash_attention").flash_attention_v_mean
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   *[ctypes.c_int] * 4, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def has_rows_without_keys(s: int, t: int, window: int) -> bool:
    """Whether some query row of (S, T, window) has no live key: rows
    i >= T + window - 1, whose window starts past the last key (causal or
    not)."""
    return window > 0 and t >= 1 and s >= t + window


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0):
    """Launch a kernel on contiguous CUDA tensors q (B,S,H,hd) and k, v
    (B,T,KV,hd) of one type, f32 or bf16, 16-byte aligned (cp.async or
    TMA loads), with H % KV == 0 and hd in ``HEAD_DIMS``; bf16 also needs
    T >= 1.  Returns o (B,S,H,hd) in q's type."""
    global LAUNCHES, SM90_LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.dtype not in build.DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention needs q, k, v all float32 or "
                            f"all bfloat16, {name} is {t.dtype} and q "
                            f"{q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention needs contiguous 4-D tensors, "
                             f"{name} has shape {tuple(t.shape)}, "
                             f"contiguous={t.is_contiguous()}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or kv == 0 or h % kv != 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} need "
                         f"q (B,S,H,hd), k = v (B,T,KV,hd), H % KV == 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, "
                         f"got {hd}")
    o = torch.empty_like(q)
    if b == 0 or s == 0 or h == 0:
        return o
    sm90 = q.dtype == torch.bfloat16
    if sm90 and t == 0:
        raise ValueError("flash_attention in bfloat16 needs T >= 1 keys")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention needs 16-byte aligned tensors "
                             f"(TMA or cp.async loads), {name} is not")
    lib = "flash_attention_sm90" if sm90 else "flash_attention"
    fn = build.load(lib, _SM90_ARGTYPES if sm90 else _ARGTYPES)
    shape = (b, s, t, h, kv, hd, int(causal), int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        vmean = None
        if has_rows_without_keys(s, t, window):
            vmean = torch.empty((b, kv, hd), dtype=torch.float32,
                                device=q.device)
            rc = _v_mean_fn()(v.data_ptr(), build.DTYPE_CODES[v.dtype],
                              vmean.data_ptr(), b, t, kv, hd, stream)
            build.check("flash_attention", rc)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if vmean is None else vmean.data_ptr())
        rc = (fn(*ptrs, *shape, stream) if sm90 else
              fn(*ptrs, build.DTYPE_CODES[q.dtype], *shape, stream))
    build.check(lib, rc)
    LAUNCHES += 1
    SM90_LAUNCHES += int(sm90)
    return o


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    use_kernel: bool = True):
    """GQA-aware attention forward: q (B,S,H,hd), k/v (B,T,KV,hd) ->
    (B,S,H,hd) in q.dtype.  Causal keeps keys j <= i; ``window`` > 0 keeps
    i - j < window (positions count from 0 in q and in k)."""
    if q.is_cuda and use_kernel is not False:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
