"""Plain PyTorch version of the flash-attention kernel (GQA, causal,
sliding window)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd) in q.dtype.

    Step for step ``repro.kernels.flash_attention.ref.flash_attention_ref``:
    the kv heads repeated to H, f32 scores, masked scores set to -1e30, a
    softmax over the keys, the f32 product with v, cast to q's type.  It
    materialises the (B, H, S, T) scores.  ``q_offset`` is the position of
    q's first row (0 in the reference), so that a caller can hold a slice
    of the rows against the kernel's output.
    """
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    t, kv = k.shape[1], k.shape[2]
    rep = h // kv
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bshk,bthk->bhst", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    qp = torch.arange(q_offset, q_offset + s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (qp - kp < window)
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthk->bshk", probs, v.to(torch.float32))
    return out.to(q.dtype)
