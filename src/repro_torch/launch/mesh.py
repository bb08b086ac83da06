"""LM meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``).

The reference lays one program out over a device mesh and its compiler
inserts the collectives.  The port runs one process per mesh position:
an :class:`LMMesh` names the axes (``("pod", "data", "model")`` or
``("data", "model")``), their sizes, this process's coordinates, and one
process group per slice of every set of axes (the ranks that differ only
along those axes).  Ranks are laid out rank-major, as ``jax.make_mesh``
orders devices: the last axis varies fastest, so the ranks of one
``model`` group are consecutive.

A mesh with every axis of size 1 has no group and calls no collective.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional


@dataclasses.dataclass(frozen=True, eq=False)
class LMMesh:
    """This rank's place in a mesh of ``sizes`` over ``axis_names``.

    ``shape`` maps each axis to its size, as a ``jax.sharding.Mesh``'s
    does, so the partition rules (``parallel.sharding``) read either.
    ``groups`` maps a sorted tuple of axes to the process group of this
    rank's slice along them; a slice of one rank has no group."""

    axis_names: tuple
    sizes: tuple
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or names; axes the
        mesh lacks count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh
        lacks)."""
        if axis not in self.axis_names:
            return 0
        i = self.axis_names.index(axis)
        stride = math.prod(self.sizes[i + 1:])
        return (self.rank // stride) % self.sizes[i]

    def index(self, axes) -> int:
        """This rank's index within its slice along ``axes``, the first
        axis slowest (its rank in :meth:`group`)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coord(a)
        return idx

    def group(self, axes):
        """The process group of this rank's slice along ``axes``, or None
        when that slice is this rank alone."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if self.size(key) == 1:
            return None
        return self.groups[key]


def _slices(sizes: tuple, axes_idx: tuple) -> list:
    """Every slice of the rank-major mesh ``sizes`` along the axes
    ``axes_idx``: lists of ranks, the others' coordinates fixed."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i not in axes_idx]
    out = []
    for fixed in itertools.product(*(range(sizes[i]) for i in others)):
        base = sum(c * strides[i] for c, i in zip(fixed, others))
        out.append([base + sum(c * strides[i] for c, i in zip(var, axes_idx))
                    for var in itertools.product(*(range(sizes[i])
                                                   for i in axes_idx))])
    return out


def build_mesh(axis_names: tuple, sizes: tuple) -> LMMesh:
    """An :class:`LMMesh` of ``sizes`` over the default process group
    (whose world size must be their product), with a group for every
    slice of more than one rank.  ``new_group`` is collective: every rank
    builds the same groups in the same order.  With no process group
    initialised the sizes must all be 1."""
    import torch.distributed as dist
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of {dict(zip(axis_names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the world has {world}")
    rank = dist.get_rank() if up else 0
    groups = {}
    for r in range(1, len(sizes) + 1):
        for idx in itertools.combinations(range(len(sizes)), r):
            if math.prod(sizes[i] for i in idx) == 1:
                continue
            key = tuple(axis_names[i] for i in idx)
            for ranks in _slices(sizes, idx):
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
                if rank in ranks:
                    groups[key] = g
    return LMMesh(axis_names, sizes, rank, groups)


def make_local_mesh(model_parallel: int = 1, pods: int = 1) -> LMMesh:
    """A mesh over every rank of the default group (one rank when none is
    initialised): ``(pods, data, model_parallel)`` over ``("pod", "data",
    "model")`` when ``pods`` > 1, else ``(data, model_parallel)`` over
    ``("data", "model")``; ``data`` takes the ranks that are left."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else 1
    if n % (model_parallel * pods):
        raise ValueError(f"{n} ranks do not split into {pods} pod(s) x "
                         f"model parallel {model_parallel}")
    data = n // (model_parallel * pods)
    if pods > 1:
        return build_mesh(("pod", "data", "model"),
                          (pods, data, model_parallel))
    return build_mesh(("data", "model"), (data, model_parallel))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """The reference's production mesh, (16, 16) or (2, 16, 16): it needs
    256 or 512 ranks, and raises with fewer, as the reference does without
    its devices."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    up = dist.is_available() and dist.is_initialized()
    have = dist.get_world_size() if up else 1
    if have < need:
        raise RuntimeError(f"production mesh needs {need} ranks, found "
                           f"{have}")
    return build_mesh(axes, shape)


def rank_device(rank: int, device: Optional[str] = None):
    """The device a rank runs on: ``cuda:(rank % device_count)`` unless
    ``device`` names the CPU."""
    import torch
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev
