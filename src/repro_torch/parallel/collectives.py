"""The collectives of LM sharding, and their autograd rules.

Every function takes a process group (an :class:`~repro_torch.launch.
mesh.LMMesh` slice) and is the identity when the group is None, which is
how an axis of size 1 calls nothing.

Gloo carries CPU tensors for every collective used here but CUDA tensors
for only some (it has no CUDA all-gather or reduce-scatter), so a CUDA
tensor on a gloo group is staged through host memory explicitly: copied
to the host, reduced or gathered there, and copied back.  That is how
ranks that share one card run; NCCL groups take the card's tensors as
they are.  bf16 is reduced in f32 (each value exact) and rounded back.

The differentiable forms follow tensor parallelism's two rules: a
replicated value entering a sharded computation is the identity forward
and an all-reduce of its gradient backward (:func:`copy_to`), and a
partial sum leaving one is an all-reduce forward and the identity
backward (:func:`reduce_from`).  :func:`gather_from` concatenates shards
along a dimension and hands each rank its slice of the gradient;
:func:`fsdp_gather` is FSDP's all-gather, whose gradient is
reduce-scattered (summed) back to the shards; :func:`sum_over` is an
all-reduce whose gradient is all-reduced too, for statistics that every
rank of a batch group adds into its own share of the loss.
"""
from __future__ import annotations

import torch


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group carries it (on the host for gloo, bf16 as f32):
    a fresh contiguous copy, which the collective may overwrite."""
    dtype = (torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
             else t.dtype)
    device = "cpu" if _staged(t, group) else t.device
    return torch.empty(t.shape, dtype=dtype, device=device).copy_(t)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor of ``t``'s type and
    device (``t`` itself when the group is None)."""
    if group is None:
        return t
    import torch.distributed as dist
    w = _wire(t.detach(), group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``t``s concatenated along ``dim`` in group-rank
    order."""
    if group is None:
        return t
    import torch.distributed as dist
    w = _wire(t.detach(), group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut into equal parts along ``dim``:
    this rank's part."""
    if group is None:
        return t
    import torch.distributed as dist
    n = dist.get_world_size(group)
    w = _wire(t.detach(), group)
    parts = [p.contiguous() for p in torch.chunk(w, n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out.to(device=t.device, dtype=t.dtype)


def broadcast_object(obj, group=None, src: int = 0):
    """``obj`` of the group's rank ``src`` on every rank (pickled)."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        if dim is None:
            return x.view_as(x)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            return all_reduce(g, ctx.group), None, None
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passes as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` forward; each rank's slice of the
    gradient backward."""
    return x if group is None else _GatherFrom.apply(x, dim, group)


def fsdp_gather(x: torch.Tensor, dim, group) -> torch.Tensor:
    """FSDP's gather of a shard along ``dim`` (None: a replicated leaf,
    the identity); its gradient summed over ``group`` and cut back to the
    shard."""
    return x if group is None else _FsdpGather.apply(x, dim, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward and backward."""
    return x if group is None else _SumOver.apply(x, group)
