"""Model building blocks of the dense decoder families, in PyTorch.

Port of ``repro.models.layers``: RMSNorm, the RoPE variants (1d,
chatglm's 2d half, qwen2-vl's M-RoPE), GQA attention (full,
sliding-window, block-banded, cross) with the ring KV cache, the gated
MLP, the top-k MoE with capacity buckets (grouped dispatch: one group per
batch shard, :func:`moe_groups`), and the Mamba2 mixer (the chunked SSD
over a prompt, the single-step recurrence from its conv and SSM states in
decode).

Under an active LM mesh (``parallel.sharding.mesh_context``) with more
than one ``model`` rank, attention, the MLP, the MoE's experts and (in
``models.transformer``) the vocabulary run on this rank's shards, the
split the partition rules give the weights (:func:`tp_group`): heads
over ``model`` (K and V whole where the ranks do not divide them), the
MLP's width, the experts; a replicated input enters through
``collectives.copy_to`` and a partial product leaves through an
all-reduce (:func:`_row_parallel`).  Where the reference pins an
activation's layout (``shard(...)`` on q, K and V, the attention and MLP
outputs, the MoE's buckets and expert outputs) the rank's own cut is
that layout, and nothing is called.

Parameters are mappings of tensors (an ``nn.ParameterDict`` in the model)
with the reference's names and layouts: ``wq`` (d, H, hd), ``wk`` and
``wv`` (d, KV, hd), ``wo`` (H, hd, d); ``wi``, ``wg`` (d, ff), ``wo``
(ff, d); a norm's ``scale`` (d,); the MoE's ``router`` (d, E), ``wi`` and
``wg`` (E, d, f), ``wo`` (E, f, d) and its ``shared`` gated MLP; the Mamba
mixer's leaves (``mamba_init``).  The
arithmetic follows the reference step for step, in the same types:
scores and logits are f32 products of the activation-type operands, the
probabilities are cast to the activation type before P·V, and a bf16 q
or k comes out of RoPE in f32.

Attention over a prompt on a CUDA tensor, self-attention (causal or
not: the whisper encoder's is not) and cross-attention onto the encoder's
output alike, runs on the hand-written flash kernels
(``kernels/flash_attention``) unless the caller passes ``use_kernel=False``
or ``index_positions=False`` (positions other than 0..s-1); a decode
step (its self- and cross-attention) and the CPU stay plain torch, as the
reference computes them outside any Pallas kernel, and so does a
training forward (the kernels have no backward; the reference trains
through the plain attention too).

Every matrix is cast to the activation type where it is used, so the
same functions run the serving model's pre-cast weights and the f32
masters of training.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import _divisible, active_mesh, rule_axes


# ---------------------------------------------------------------- meshes

def tp_group(n: int):
    """The ``model`` group when the active mesh splits a dim of ``n``
    (heads, the MLP's width, the experts, the vocabulary) over
    ``"model"``, as the partition rules split the weights along it; else
    None (no mesh, one model rank, or a dim the axis does not divide,
    which stays whole on every rank)."""
    mesh = active_mesh()
    if mesh is None or mesh.size("model") == 1 or \
            not _divisible(n, mesh, "model"):
        return None
    return mesh.group("model")


def tp_rank() -> int:
    mesh = active_mesh()
    return 0 if mesh is None else mesh.coord("model")


def _row_parallel(eq: str, a, w, tp):
    """``einsum(eq, a, w)`` whose contracted dim is split over the model
    ranks: each rank's partial product of the operands in f32 (f64 for
    f64), summed over the ranks and rounded once to a's type, as the
    unsplit product rounds once."""
    if tp is None:
        return torch.einsum(eq, a, w)
    acc = torch.promote_types(a.dtype, torch.float32)
    part = torch.einsum(eq, a.to(acc), w.to(acc))
    return C.reduce_from(part, tp).to(a.dtype)


# ---------------------------------------------------------------- init utils

def _trunc_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def _dense_init(generator, shape, in_axis=-2, device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] over sqrt(fan_in), fan_in =
    ``shape[in_axis]`` as in the reference (``wq`` (d, H, hd) takes H)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return _trunc_normal(generator, shape, device).mul_(1.0 / math.sqrt(fan_in))


def _embed_init(generator, shape, device=None) -> torch.Tensor:
    # 1/sqrt(d) keeps tied-head logits O(1) at init
    return _trunc_normal(generator, shape, device).mul_(
        1.0 / math.sqrt(shape[-1]))


# ---------------------------------------------------------------- norms

def rmsnorm_init(d, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-6):
    """f32 inside, ``x * (1 + scale)``, cast back to x's type.  A bf16
    scale (a training step's cast copy) enters ``1 + scale`` in f32: the
    reference's compiled step keeps that sum unrounded (it would round to
    1 in bf16 for any scale below 2**-8)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].to(torch.float32))).to(dt)


# ---------------------------------------------------------------- RoPE

def _rope_angles(positions, dim, theta):
    """positions (..., S) -> cos/sin (..., S, dim/2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs
    # cos and sin of the f32 angle, rounded once from f64: this matches the
    # reference's f32 cos and sin where torch's own f32 versions are a unit
    # in the last place off (which RoPE's differences of products magnify)
    ang = ang.to(torch.float64)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def _apply_rot(x, cos, sin):
    """x (..., dim): rotate the interleaved (even, odd) pairs by cos/sin
    (..., dim/2) and interleave them again."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x, positions, kind: str, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (B, S, 3) for mrope.  A bf16
    x comes back in f32 (its product with the f32 angles), as in the
    reference."""
    hd = x.shape[-1]
    if kind == "none":
        return x
    if kind == "rope":
        cos, sin = _rope_angles(positions, hd, theta)          # (B,S,hd/2)
        return _apply_rot(x, cos[:, :, None, :], sin[:, :, None, :])
    if kind == "rope2d":
        # chatglm: rotary on the first half of head_dim only
        half = hd // 2
        cos, sin = _rope_angles(positions, half, theta)
        rot = _apply_rot(x[..., :half], cos[:, :, None, :], sin[:, :, None, :])
        return torch.cat([rot, x[..., half:].to(rot.dtype)], dim=-1)
    if kind == "mrope":
        # qwen2-vl: head_dim split into (t, h, w) sections (2:1:1)
        if positions.dim() == 2:
            positions = torch.stack([positions] * 3, dim=-1)
        secs = [hd // 2, hd // 4, hd - hd // 2 - hd // 4]
        outs, start = [], 0
        for s_i, sec in enumerate(secs):
            cos, sin = _rope_angles(positions[..., s_i], sec, theta)
            outs.append(_apply_rot(x[..., start:start + sec],
                                   cos[:, :, None, :], sin[:, :, None, :]))
            start += sec
        return torch.cat(outs, dim=-1)
    raise ValueError(kind)


# ---------------------------------------------------------------- attention

def attention_init(generator, cfg: ModelConfig, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return {
        "wq": _dense_init(generator, (d, h, hd), device=device),
        "wk": _dense_init(generator, (d, kv, hd), device=device),
        "wv": _dense_init(generator, (d, kv, hd), device=device),
        "wo": _dense_init(generator, (h, hd, d), in_axis=0, device=device),
    }


def _expand_kv(k, n_rep):
    """(B,T,KV,hd) -> (B,T,H,hd): query head h reads kv head h // n_rep."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _gqa_scores(q, k, n_rep):
    """q (B,S,H,hd), k (B,T,KV,hd) -> (B,H,S,T): the f32 product of the
    operands as they are (bf16 products are exact in f32)."""
    k = _expand_kv(k, n_rep)
    return torch.einsum("bshk,bthk->bhst", q.to(torch.float32),
                        k.to(torch.float32))


def _gqa_out(probs, v, n_rep):
    v = _expand_kv(v, n_rep)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _banded_attention(q, k, v, q_pos, window, n_rep, scale):
    """Exact sliding-window attention in O(S·2w) instead of O(S²): query
    chunk i attends chunks {i-1, i} when the chunk length is the window."""
    b, s, h, hd = q.shape
    w = window
    nq = s // w
    k = _expand_kv(k, n_rep)
    v = _expand_kv(v, n_rep)
    qc = q.reshape(b, nq, w, h, hd)
    kc = k.reshape(b, nq, w, h, hd)
    vc = v.reshape(b, nq, w, h, hd)

    def with_prev(t, pad_val=0.0):
        prev = torch.cat([torch.full_like(t[:, :1], pad_val), t[:, :-1]],
                         dim=1)
        return torch.cat([prev, t], dim=2)             # (b, nq, 2w, ...)

    k2 = with_prev(kc)
    v2 = with_prev(vc)
    qp = q_pos.reshape(b, nq, w)
    kp2 = torch.cat([torch.cat([torch.full_like(qp[:, :1], -10**9),
                                qp[:, :-1]], dim=1), qp], dim=2)   # (b,nq,2w)

    scores = torch.einsum("bnqhk,bnthk->bhnqt", qc.to(torch.float32),
                          k2.to(torch.float32)) * scale
    mask = (kp2[:, None, :, None, :] <= qp[:, None, :, :, None]) & \
           (qp[:, None, :, :, None] - kp2[:, None, :, None, :] < w)
    scores = torch.where(mask, scores, torch.tensor(
        -1e30, dtype=torch.float32, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhnqt,bnthk->bnqhk", probs, v2)
    return out.reshape(b, s, h, hd).to(v.dtype)


def is_differentiated(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def kernel_route(*, use_kernel: bool, on_gpu: bool, index_positions: bool,
                 decode: bool, differentiated: bool) -> bool:
    """Whether attention runs on the flash kernels: over a prompt (not a
    decode step) on the GPU, when the caller allows it, when its positions
    are the indices 0..s-1 (the kernels mask by index; the reference masks
    by position), and only when the forward is not being differentiated.
    The kernels have no backward (nor has the reference's Pallas kernel:
    the reference trains through the plain attention), so a training
    forward takes the plain route on the GPU too."""
    return (use_kernel and on_gpu and index_positions and not decode
            and not differentiated)


def attention_apply(params, x, positions, cfg: ModelConfig, *, window: int = 0,
                    kv_x: Optional[torch.Tensor] = None, causal: bool = True,
                    cache: Optional[dict] = None, rope: bool = True,
                    use_kernel: bool = True, index_positions: bool = True):
    """Full/sliding/cross attention with optional KV cache.

    window > 0  => sliding-window causal mask (gemma3 local layers).
    kv_x        => cross-attention onto encoder output (no mask, no rope).
    cache       => {'k','v','pos','write_idx'} ring buffer: 'pos' (B,T) holds
      each slot's absolute position (-1 = empty), so full caches (T=max_seq)
      and sliding-window rings (T=window+pad) share one code path.  x holds
      the new token(s); decode is s==1 and writes slot ``write_idx``,
      prefill writes the last T positions to slots 0..  The port writes
      the cache's tensors in place and returns the same dict.
    use_kernel  => attention over the s > 1 tokens of x runs on the flash
      kernels when x is on the GPU: bf16 on the tensor-core kernel, f32 on
      the CUDA-core one, with q and k after RoPE cast to x's type.  That
      covers self-attention, causal or not, and cross-attention onto
      ``kv_x`` (``causal=False``: the kernel masks nothing then).  A
      decode step (s == 1: its ring attention, and its cross-attention
      onto ``kv_x``) and a forward that autograd records stay on the plain
      route (:func:`kernel_route`).
    index_positions => ``positions`` are 0..s-1, as the model gives them to
      a prompt.  The kernels mask by index where the reference masks by
      ``positions[..., 0]``, so positions a caller gives (qwen2-vl's
      M-RoPE positions, which may repeat or skip) take the plain route,
      which masks by them as the reference does.  This is a route by
      meaning, not a fallback: on the kernel route a failed build or
      launch raises.
    """
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    n_rep = h // kv
    wk, wv = params["wk"], params["wv"]
    tp = tp_group(h)
    if tp is not None:
        # this rank's heads: wq and wo hold them; K and V are split too
        # where the rank count divides KV, else whole on every rank, and
        # each rank takes the K and V heads its query heads read
        x = C.copy_to(x, tp)
        if kv_x is not None:
            kv_x = C.copy_to(kv_x, tp)
        h = params["wq"].shape[1]
        if tp_group(kv) is None:
            idx = (tp_rank() * h + torch.arange(h, device=wk.device)) // n_rep
            wk, wv = C.copy_to(wk, tp)[:, idx], C.copy_to(wv, tp)[:, idx]
            kv = h
        else:
            kv = wk.shape[1]
        n_rep = h // kv
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    src = kv_x if kv_x is not None else x
    k = torch.einsum("btd,dgk->btgk", src, wk.to(x.dtype))
    v = torch.einsum("btd,dgk->btgk", src, wv.to(x.dtype))
    if rope and kv_x is None and cfg.rope != "none":
        q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)

    q_pos = positions[..., 0] if positions.dim() == 3 else positions  # (B,S)
    slot_pos = None
    if cache is not None:
        T = cache["k"].shape[1]
        if s == 1:                                   # decode: ring write
            widx = cache["write_idx"]
            cache["k"][:, widx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, widx] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][:, widx] = q_pos[:, 0].to(torch.int32)
            # decode attends over the whole ring
            k, v, slot_pos = cache["k"], cache["v"], cache["pos"]
        else:                                        # prefill: keep last T
            start = max(s - T, 0)
            n = s - start
            cache["k"][:, :n] = k[:, start:].to(cache["k"].dtype)
            cache["v"][:, :n] = v[:, start:].to(cache["v"].dtype)
            cache["pos"][:, :n] = q_pos[:, start:].to(torch.int32)

    wo = params["wo"].to(x.dtype)
    if kernel_route(use_kernel=use_kernel, on_gpu=x.is_cuda,
                    index_positions=index_positions,
                    decode=slot_pos is not None or (kv_x is not None
                                                    and s == 1),
                    differentiated=is_differentiated(q, k, v)):
        out = flash_attention(q.to(x.dtype).contiguous(),
                              k.to(x.dtype).contiguous(), v.contiguous(),
                              causal=causal, window=window)
        return _row_parallel("bshk,hkd->bsd", out, wo, tp), cache

    # block-banded path for sliding-window layers (train/prefill)
    if (cfg.attn_impl == "banded" and window > 0 and kv_x is None
            and slot_pos is None and s % window == 0 and s // window >= 2):
        out = _banded_attention(q, k, v, q_pos, window, n_rep,
                                1.0 / math.sqrt(hd))
        return _row_parallel("bshk,hkd->bsd", out, wo, tp), cache

    scores = _gqa_scores(q, k, n_rep) / math.sqrt(hd)      # (B,H,S,T) f32

    if slot_pos is not None:
        sp = slot_pos[:, None, None, :]
        mask = (sp >= 0) & (sp <= q_pos[:, None, :, None])
        if window > 0:
            mask = mask & (q_pos[:, None, :, None] - sp < window)
    elif kv_x is not None:
        mask = None                                            # cross: dense
    else:
        kv_pos = q_pos
        mask = (kv_pos[:, None, None, :] <= q_pos[:, None, :, None]
                if causal else None)
        if window > 0:
            wmask = q_pos[:, None, :, None] - kv_pos[:, None, None, :] < window
            mask = wmask if mask is None else (mask & wmask)

    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(
            -1e30, dtype=torch.float32, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, v, n_rep)
    return _row_parallel("bshk,hkd->bsd", out, wo, tp), cache


# ---------------------------------------------------------------- gated MLP

def mlp_init(generator, d, d_ff, device=None) -> dict:
    return {"wi": _dense_init(generator, (d, d_ff), device=device),
            "wg": _dense_init(generator, (d, d_ff), device=device),
            "wo": _dense_init(generator, (d_ff, d), device=device)}


def _silu(g):
    """``jax.nn.silu`` as the reference's compiler evaluates it: g times
    the logistic, which in bf16 is 1 / (1 + exp(-g)) rounded to bf16 at
    each step (``F.silu`` and ``torch.sigmoid`` round once, and differ in
    about a third of the elements); in f32 ``torch.sigmoid`` agrees with
    it to the last place in all but a few."""
    if g.dtype == torch.float32:
        return g * torch.sigmoid(g)
    return g * (1.0 / (1.0 + torch.exp(-g)))


def mlp_apply(params, x, tp=None):
    """The gated MLP.  ``tp``: the model group its width is split over
    (:func:`tp_group` of the full width); ``wi`` and ``wg`` hold this
    rank's columns and ``wo`` its rows, whose partial products are summed
    over the group."""
    x = C.copy_to(x, tp)
    h = torch.einsum("bsd,df->bsf", x, params["wi"].to(x.dtype))
    g = torch.einsum("bsd,df->bsf", x, params["wg"].to(x.dtype))
    h = _silu(g) * h
    return _row_parallel("bsf,fd->bsd", h, params["wo"].to(x.dtype), tp)


# ---------------------------------------------------------------- MoE

def moe_init(generator, d, m, device=None) -> dict:
    """Router (d, E), experts ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f, d)
    with fan-in on axis 1, and a ``shared`` gated MLP of width
    ``n_shared * d_ff_shared`` where ``n_shared`` > 0; drawn in that order
    from ``generator`` on ``device``."""
    e, f = m.n_experts, m.d_ff_expert
    p = {"router": _dense_init(generator, (d, e), device=device),
         "wi": _dense_init(generator, (e, d, f), in_axis=1, device=device),
         "wg": _dense_init(generator, (e, d, f), in_axis=1, device=device),
         "wo": _dense_init(generator, (e, f, d), in_axis=1, device=device)}
    if m.n_shared:
        fs = m.d_ff_shared or f
        p["shared"] = mlp_init(generator, d, m.n_shared * fs, device=device)
    return p


def moe_capacity(n_tokens: int, m) -> int:
    """Slots per expert: the reference's expression, in its order."""
    return max(int(np.ceil(n_tokens * m.top_k / m.n_experts
                           * m.capacity_factor)), 4)


def moe_router(router, xt, k: int):
    """f32 gates (T, E) of the tokens ``xt`` (T, d), their softmax, and the
    top ``k`` probabilities and experts of each token, largest first and
    the lower expert first among equal ones, as ``lax.top_k`` orders them
    (a stable descending sort; ``torch.topk`` promises no order on ties).
    The softmax is the reference's: exp(g - max) over its sum."""
    gates = torch.einsum("td,de->te", xt.to(torch.float32),
                         router.to(torch.float32))
    ex = torch.exp(gates - gates.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    topi = order[:, :k]
    return gates, probs, torch.gather(probs, 1, topi), topi


def moe_dispatch(topi, cap: int):
    """The capacity routes of the top-k experts ``topi`` (T, k): the
    stable sort of the flat (token, slot) expert ids, each sorted entry's
    expert and its rank among that expert's entries, ``cap`` where the rank
    passes the capacity (a dropped slot).  Returns (sort_idx, sorted_e,
    rank_c), each (T * k,) int64."""
    flat = topi.reshape(-1)
    sort_idx = torch.sort(flat, stable=True).indices
    sorted_e = flat[sort_idx]
    seg = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(flat.numel(), device=flat.device) - seg
    return sort_idx, sorted_e, torch.where(rank < cap, rank,
                                           torch.full_like(rank, cap))


def moe_experts(params, xt, topw, routes, cap: int, tp=None):
    """The routed experts' combined output (T, d) in xt's type, for the
    tokens ``xt`` (T, d) on ``routes`` (:func:`moe_dispatch`) with their
    renormalized weights ``topw`` (T, k).  The buckets (E, cap, d) hold
    each expert's first ``cap`` entries in sorted order (the rest are
    dropped and give 0); the experts are three batched products of xt's
    type; each token sums its k rows times their weights.  The combine
    follows the reference's compiled bf16 form: the weights rounded to
    xt's type, the k products summed in f32 (f64 for f64 input) in slot
    order and rounded once.

    ``tp``: the model group the experts are split over; ``params`` hold
    this rank's E / ranks experts.  Each rank buckets and runs only its
    own experts and scatters only their rows, the others' read as 0, and
    the partial sums are all-reduced over the group before the rounding
    (the reference's ``_combine_manual``)."""
    sort_idx, sorted_e, rank_c = routes
    t, d = xt.shape
    k = topw.shape[1]
    e = params["wi"].shape[0]
    dt = xt.dtype
    acc_t = torch.promote_types(dt, torch.float32)
    if tp is not None:
        local = sorted_e - tp_rank() * e
        mine = (local >= 0) & (local < e)
        sorted_e = torch.clamp(local, 0, e - 1)
        rank_c = torch.where(mine, rank_c, torch.full_like(rank_c, cap))
    # buckets with one spare slot per expert for the dropped entries
    bkt = xt.new_zeros((e, cap + 1, d)).index_put(
        (sorted_e, rank_c), xt[sort_idx // k])[:, :cap]
    h = torch.einsum("ecd,edf->ecf", bkt, params["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", bkt, params["wg"].to(dt))
    h = _silu(g) * h
    expert_out = torch.einsum("ecf,efd->ecd", h, params["wo"].to(dt))

    # back to (token, slot) order; a dropped slot reads the zero row
    rows = torch.cat([expert_out, expert_out.new_zeros((e, 1, d))],
                     dim=1)[sorted_e, rank_c]
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(sort_idx.numel(), device=sort_idx.device)
    prod = (rows[inv].reshape(t, k, d).to(acc_t)
            * topw.to(dt).to(acc_t)[..., None])
    acc = prod[:, 0]
    for j in range(1, k):
        acc = acc + prod[:, j]
    return C.reduce_from(acc, tp).to(dt)


# process-wide, as the active mesh is (``parallel.sharding._state``)
_DISPATCH = types.SimpleNamespace(groups=None)


@contextlib.contextmanager
def dispatch_groups(groups: int):
    """Inside, :func:`moe_apply` with no mesh of more than one rank cuts
    one process's tokens into ``groups`` dispatch groups, as a mesh of
    that many batch shards would (the unsplit step that a sharded one's
    grouped dispatch is held against, and the grouped math held against
    the reference without ranks)."""
    prev = _DISPATCH.groups
    _DISPATCH.groups = groups
    try:
        yield
    finally:
        _DISPATCH.groups = prev


def moe_groups(n_tokens: int):
    """(local groups, batch group, batch ranks) of the grouped dispatch
    (the reference's ``_moe_batch_axes``).  The reference cuts the T
    tokens into G groups, one per batch shard (G the product of the active
    rules' batch axes), when ``T % G == 0`` and ``T / G >= 8``, and each
    group sorts and buckets its own tokens with its own capacity.  On the
    ranks of a mesh this rank's ``n_tokens`` are one group, and the batch
    group is the process group the aux losses' sums cross.  In one
    process, :func:`dispatch_groups` sets G."""
    mesh, axes = active_mesh(), rule_axes("batch")
    groups = _DISPATCH.groups if mesh is None or mesh.world == 1 else None
    if groups is not None:
        ok = groups > 1 and n_tokens % groups == 0 \
            and n_tokens // groups >= 8
        return (groups if ok else 1), None, 1
    if mesh is None or mesh.size(axes) == 1:
        return 1, None, 1
    if n_tokens < 8:
        raise NotImplementedError(
            f"{n_tokens} tokens a rank: the reference dispatches fewer than "
            f"8 a batch shard as one group of all the ranks' tokens, which "
            f"the port does not gather")
    return 1, mesh.group(axes), mesh.size(axes)


def moe_apply(params, x, m):
    """Top-k MoE, capacity-bucketed, grouped dispatch (:func:`moe_groups`;
    one group outside a mesh).  x: (B, S, d).  Returns (out (B, S, d),
    ``{"moe_lb", "moe_z"}`` f32 0-d).

    Every token of x takes capacity, the padding of a left-padded prompt
    too, as in the reference.  The shared experts' output is added to the
    routed experts' in f32 and the sum rounded once, as the reference's
    compiled bf16 layer does.  The aux losses are over all the batch's
    tokens, every group's and every batch rank's: the probability sums,
    the expert counts and the z-loss's sum are all-reduced over the batch
    group.

    Under a mesh that splits the experts over ``"model"`` the router
    ``(d, E)`` holds this rank's columns and is gathered whole before the
    top-k, so every rank routes every token alike; each rank runs its own
    experts (:func:`moe_experts`)."""
    b, s, d = x.shape
    T = b * s
    dt = x.dtype
    xt = x.reshape(T, d)
    e, k = m.n_experts, m.top_k
    tp = tp_group(e)
    router = C.gather_from(params["router"], 1, tp)
    gates, probs, topv, topi = moe_router(router, xt, k)
    topw = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    n_groups, batch_group, ranks = moe_groups(T)
    tg = T // n_groups
    cap = moe_capacity(tg, m)
    xe, we = C.copy_to(xt, tp), C.copy_to(topw, tp)
    outs = [moe_experts(params, xe[g * tg:(g + 1) * tg],
                        we[g * tg:(g + 1) * tg],
                        moe_dispatch(topi[g * tg:(g + 1) * tg], cap), cap,
                        tp=tp)
            for g in range(n_groups)]
    out = outs[0] if n_groups == 1 else torch.cat(outs)
    if "shared" in params:
        acc_t = torch.promote_types(dt, torch.float32)
        fs = m.n_shared * (m.d_ff_shared or m.d_ff_expert)
        sh = mlp_apply(params["shared"], x, tp=tp_group(fs)).reshape(T, d)
        out = (out.to(acc_t) + sh.to(acc_t)).to(dt)

    # aux losses: load balance (Switch) and the router's z-loss
    counts = torch.bincount(topi.reshape(-1), minlength=e)
    lse2 = torch.logsumexp(gates, dim=-1).square()
    if batch_group is None:
        me = probs.sum(dim=0) * (1.0 / T)
        z = lse2.mean()
    else:
        T = T * ranks
        me = C.sum_over(probs.sum(dim=0), batch_group) * (1.0 / T)
        counts = C.all_reduce(counts, batch_group)
        z = C.sum_over(lse2.sum(), batch_group) / T
    ce = counts.to(torch.float32) * (1.0 / (T * k))
    lb = e * torch.sum(me * ce)
    return out.reshape(b, s, d), {"moe_lb": lb, "moe_z": m.router_zloss * z}


# ---------------------------------------------------------------- Mamba2 SSD

# XLA:CPU rewrites a cumulative sum longer than this into blocks of it
# (``_cumsum``)
_SCAN_BASE = 16


def mamba_init(generator, cfg: ModelConfig, device=None) -> dict:
    """One Mamba2 mixer's f32 parameters, drawn from ``generator`` in the
    order ``in_proj``, ``conv_w``, ``dt_bias``, ``out_proj``: ``in_proj``
    (d, 2 d_in + 2 g n + nh) giving [z, x, B, C, dt], the depthwise
    ``conv_w`` (cw, ch) with fan-in on axis 0 and its bias, ``A_log`` =
    log(1..nh), ``D`` ones, ``dt_bias`` the inverse softplus of a uniform
    draw on [1e-3, 0.1], the gated norm over d_in and ``out_proj``
    (d_in, d)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    in_proj = _dense_init(generator, (d, 2 * d_in + 2 * gn + nh),
                          device=device)
    conv_w = _dense_init(generator, (s.conv_width, d_in + 2 * gn), in_axis=0,
                         device=device)
    u = torch.empty((nh,), dtype=torch.float32, device=device).uniform_(
        1e-3, 0.1, generator=generator)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in + 2 * gn,), dtype=torch.float32,
                              device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.clamp(u, min=1e-4))),
        "norm": rmsnorm_init(d_in, device),
        "out_proj": _dense_init(generator, (d_in, d), device=device),
    }


def _seq_cumsum(a):
    """Cumulative sums along the last axis, added one element at a time
    in a's type."""
    out = [a[..., 0]]
    for j in range(1, a.shape[-1]):
        out.append(out[-1] + a[..., j])
    return torch.stack(out, dim=-1)


def _cumsum(a):
    """``jnp.cumsum`` along the last axis as the reference's compiler
    evaluates it: in blocks of ``_SCAN_BASE`` (the last one padded), each
    summed element by element in a's type, then each block plus the
    exclusive prefix of the block totals, found the same way.  In bf16
    every addition rounds to bf16; ``torch.cumsum`` sums in another order
    (in f64 or f32 on the CPU), and ``_segsum``'s ``exp`` magnifies the
    difference: with it in this one's place, half the outputs of a bf16
    SSD at smoke width (4,103 of 8,192) differ from the reference's,
    against 0 to 2 of 8,192-16,384 here.  f32 holds its tolerance either
    way."""
    q = a.shape[-1]
    if q <= _SCAN_BASE:
        return _seq_cumsum(a)
    nb = -(-q // _SCAN_BASE)
    if nb * _SCAN_BASE > q:
        a = torch.nn.functional.pad(a, (0, nb * _SCAN_BASE - q))
    blocks = _seq_cumsum(a.reshape(*a.shape[:-1], nb, _SCAN_BASE))
    before = _cumsum(blocks[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]],
                       dim=-1)
    out = (blocks + before[..., None]).reshape(*a.shape[:-1],
                                               nb * _SCAN_BASE)
    return out[..., :q]


def _segsum(a, cs=None):
    """a: (..., Q) -> (..., Q, Q): ``cs[i] - cs[j]`` for j <= i and -inf
    above the diagonal, cs the cumulative sums of a (``_cumsum``; pass
    them as ``cs`` when they are at hand).  Its exp is the SSD's decay
    matrix; the -inf entries give exact zeros and zero gradients."""
    q = a.shape[-1]
    if cs is None:
        cs = _cumsum(a)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                dtype=diff.dtype,
                                                device=diff.device))


def _ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """The state-space dual (Mamba2 §6) in chunks of ``chunk`` tokens.

    x (b,s,h,p), dt (b,s,h) (softplus'd), A (h,) < 0, B and C (b,s,g,n)
    shared by the h // g heads of a group.  Returns (y (b,s,h,p), the final
    state (b,h,p,n)), both in x's type; ``init_state`` (b,h,p,n) is the
    state before the first token (zeros when None).

    The reference's three einsums are written as the pairwise products its
    compiler makes of them, in its order, each rounded to x's type: the
    diagonal blocks C·B over n, times the decay matrix, times x·dt over the
    chunk's tokens; each chunk's state as decay·(x·dt) times B over the
    tokens; the carried-in part as the previous state times C over n,
    times the decay from the chunk's start.  The chunks' states are
    carried in order, ``new = carry * decay + state``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    # (b,c,h,q,n): each head reads its group's B and C
    Bh = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep,
                                 dim=3).transpose(2, 3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep,
                                 dim=3).transpose(2, 3)

    a = (dtc * A).transpose(2, 3)                            # (b,c,h,q)
    a_cum = _cumsum(a)
    L = torch.exp(_segsum(a, a_cum))                         # (b,c,h,q,k)
    xdt = (xc * dtc[..., None]).transpose(2, 3)              # (b,c,h,k,p)

    y_diag = torch.matmul(torch.matmul(Ch, Bh.transpose(-1, -2)) * L, xdt)

    decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (b,c,h,q)
    states = torch.matmul((decay_states[..., None] * xdt).transpose(-1, -2),
                          Bh)                                # (b,c,h,p,n)
    chunk_decay = torch.exp(a_cum[..., -1])                  # (b,c,h)

    carry = (x.new_zeros((b, h, p, n)) if init_state is None
             else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,c,h,p,n)

    state_decay = torch.exp(a_cum)                           # (b,c,h,q)
    y_off = (torch.matmul(prev_states, Ch.transpose(-1, -2)).transpose(-1, -2)
             * state_decay[..., None])                       # (b,c,h,q,p)
    y = (y_diag + y_off).transpose(2, 3).reshape(b, s, h, p)
    return y, carry


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    NaN kept (``F.softplus`` is log1p(exp(x)) below a threshold and rounds
    differently)."""
    out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def _depthwise_conv(ctx, w, s: int):
    """out[t] = sum over i of ctx[t + i] * w[i] for t < s: the f32 (f64
    for f64 input) sum of the cw products in order, rounded once to ctx's
    type.  ctx (B, s + cw - 1, ch), w (cw, ch) in ctx's type."""
    acc_t = torch.promote_types(ctx.dtype, torch.float32)
    acc = None
    for i in range(w.shape[0]):
        t = ctx[:, i:i + s].to(acc_t) * w[i].to(acc_t)
        acc = t if acc is None else acc + t
    return acc.to(ctx.dtype)


def mamba_apply(params, x, cfg: ModelConfig, cache: Optional[dict] = None):
    """One Mamba2 mixer.  x (B, S, d).  Returns (out (B, S, d), cache).

    ``cache`` ``{"conv": (B, cw-1, ch), "ssm": (B, nh, p, n)}``: with S == 1
    a single recurrence step from it; with S > 1 a prefill, which runs the
    chunked SSD from the cached SSM state and leaves the final state and
    the last cw - 1 conv inputs in it.  The cache's tensors are written in
    place and the same dict returned (None without a cache).  The SSM state
    is carried in f32 across decode steps and in x's type inside a prefill,
    as in the reference.

    As the reference: the chunk is ``cfg.ssm.chunk`` (at most S), and the
    whole sequence when S is not a multiple of it; a left-padded prompt's
    pads run through the conv and the state like any token; and a prefill
    of fewer than cw - 1 tokens has no conv state to hand over (the
    reference's is None and fails), which raises ``ValueError`` here.

    The arithmetic follows the reference's compiled layer: every op in x's
    type, rounded at each step (``_cumsum``, ``_silu``), the products
    f32-accumulated and rounded once, ``A = -exp(A_log)`` in A_log's type
    and then cast, dt's softplus in f32 on the f32 bias, and the gate's
    product ``y * silu(z)`` reaching the norm unrounded."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    dt_ = x.dtype
    acc_t = torch.promote_types(dt_, torch.float32)
    d_in = s_cfg.expand * d
    nh = d_in // s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state
    gn = g * n
    cw = s_cfg.conv_width
    proj = torch.einsum("bsd,de->bse", x, params["in_proj"].to(dt_))
    z, xs, Bm, Cm, dt = torch.split(proj, [d_in, d_in, gn, gn, nh], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                # (B,S,ch)
    w = params["conv_w"].to(dt_)
    decode = cache is not None and s == 1
    if decode:
        ctx = torch.cat([cache["conv"].to(dt_), conv_in], dim=1)
        conv_out = _depthwise_conv(ctx[:, -cw:], w, 1)
        new_conv = ctx[:, -(cw - 1):]
    else:
        if cache is not None and s < cw - 1:
            raise ValueError(
                f"a Mamba prefill of {s} tokens is shorter than conv_width - "
                f"1 = {cw - 1}: there is no conv state to hand to decode (the "
                f"reference's is None there and fails)")
        pad = torch.nn.functional.pad(conv_in, (0, 0, cw - 1, 0))
        conv_out = _depthwise_conv(pad, w, s)
        new_conv = pad[:, -(cw - 1):]
    conv_out = _silu(conv_out + params["conv_b"].to(dt_))
    xs, Bm, Cm = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(b, s, nh, s_cfg.head_dim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dt = _softplus(dt.to(acc_t) + params["dt_bias"]).to(dt_)   # (B,S,nh)
    A = -torch.exp(params["A_log"]).to(dt_)                  # (nh,)
    D = params["D"].to(dt_)[None, None, :, None]

    if decode:
        st = cache["ssm"].to(acc_t)
        dtq = dt[:, 0]                                       # (B,nh)
        # exp(dt * A) and x * dt are each cast to f32 at once: the
        # reference's compiler leaves them unrounded (dt * A is rounded)
        dA = torch.exp((dtq * A).to(acc_t))
        Bq = torch.repeat_interleave(Bm[:, 0], nh // g, dim=1).to(acc_t)
        Cq = torch.repeat_interleave(Cm[:, 0], nh // g, dim=1).to(acc_t)
        xq = xs[:, 0].to(acc_t) * dtq.to(acc_t)[..., None]   # (B,nh,p)
        st = st * dA[..., None, None] + xq[..., :, None] * Bq[..., None, :]
        y = torch.matmul(st, Cq[..., None])[..., 0]          # (B,nh,p)
        y = y.to(dt_)[:, None] + D * xs
        final = st
    else:
        chunk = min(s_cfg.chunk, s)
        if s % chunk:
            chunk = s                      # the reference's one-chunk fallback
        init_state = cache["ssm"] if cache is not None else None
        y, final = _ssd_chunked(xs, dt, A, Bm, Cm, chunk,
                                init_state=init_state)
        y = y + D * xs
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(final)
    y = y.reshape(b, s, d_in)
    y = rmsnorm(params["norm"], y.to(acc_t) * _silu(z).to(acc_t)).to(dt_)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(dt_))
    return out, cache
