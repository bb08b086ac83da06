"""The fleet's site axis split over ``torch.distributed`` ranks — the site
helpers of ``repro.parallel.sharding``.

The reference splits the site axis over a 1-D ``("sites",)`` device mesh
inside one process.  The port splits it over the ranks of a process
group: rank r of W holds sites ``[r * E_pad / W, (r + 1) * E_pad / W)``,
where ``E_pad`` is E rounded up to a multiple of W (:func:`site_pad`).
With no process group initialised W is 1, nothing is padded and no
collective is called.

Every cross-site value the port needs is already on the host (the
water-fill runs on host numpy, the drift gate's branch and the event
loop's plan are read there, and the report is assembled there), so every
collective carries host tensors over a gloo group: the default group when
its backend is gloo, else one ``new_group(backend="gloo")`` made once.
Gloo also lets several ranks share one card.

The second half is the LM stack's partition rules
(``ACTIVATION_RULES``, :func:`mesh_context`, :func:`param_partition_spec`,
:func:`tree_pspecs`, :func:`gather_block_constraint` ...) over an
:class:`~repro_torch.launch.mesh.LMMesh` of ranks, and the layout they
give a parameter tree (:class:`LMShards`): FSDP over ``data``, tensor
parallelism over ``model``.  The reference states a layout and its
compiler inserts the collectives; the port's layers run on their local
shards and call the collectives themselves (``parallel.collectives``),
so an activation's layout is fixed by the layer's own cuts and
:func:`logical_sharding_constraint` returns its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import types
from typing import Optional

import numpy as np
import torch

# the gloo group made for a default group of another backend, keyed by
# that group (``new_group`` is collective, so it is made once)
_GLOO_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class SiteGroup:
    """This process's place in the site group: its rank, the world size,
    and the gloo group the host collectives use (None when W is 1)."""

    rank: int = 0
    world: int = 1
    gloo: Optional[object] = None


def site_group() -> SiteGroup:
    """The caller's site group: the default process group's rank and world
    size, or rank 0 of 1 when ``torch.distributed`` is not initialised.
    Creates no process group of its own but the gloo one a non-gloo
    default group needs."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return SiteGroup()
    world = dist.get_world_size()
    if world == 1:
        return SiteGroup()
    default = dist.group.WORLD
    if dist.get_backend(default) == "gloo":
        gloo = default
    else:
        if default not in _GLOO_GROUPS:
            _GLOO_GROUPS[default] = dist.new_group(backend="gloo")
        gloo = _GLOO_GROUPS[default]
    return SiteGroup(rank=dist.get_rank(), world=world, gloo=gloo)


def site_pad(n_sites: int, n_devices: int) -> int:
    """Rows to append so the site axis divides the rank count."""
    return (-int(n_sites)) % int(n_devices)


def pad_site_axis(x, n_padded: int, fill=0):
    """Pad a site-leading tensor or host array with ``fill`` rows up to
    ``n_padded`` sites.  Callers mask the extra rows as permanently dead
    sites (:func:`~repro_torch.chaos.padded_liveness_table`) or slice them
    off the result."""
    e = x.shape[0]
    if int(n_padded) == e:
        return x
    shape = (int(n_padded) - e,) + tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)])
    x = np.asarray(x)
    return np.concatenate([x, np.full(shape, fill, x.dtype)])


@dataclasses.dataclass(frozen=True)
class SiteShard:
    """One rank's rows of a fleet of ``n_sites`` sites padded to
    ``n_padded`` (a multiple of the world size)."""

    group: SiteGroup
    n_sites: int
    n_padded: int

    def __post_init__(self):
        if self.n_padded < self.n_sites or self.n_padded % self.group.world:
            raise ValueError(
                f"n_padded ({self.n_padded}) must be >= n_sites "
                f"({self.n_sites}) and a multiple of the "
                f"{self.group.world}-rank site group")

    @property
    def rows(self) -> int:
        """How many site rows each rank holds."""
        return self.n_padded // self.group.world

    @property
    def offset(self) -> int:
        """The fleet index of this rank's first row."""
        return self.group.rank * self.rows

    def local_rows(self, x, fill=0):
        """This rank's rows of a full (E-row) tensor or host array, padded
        with ``fill`` rows to ``n_padded`` first."""
        x = pad_site_axis(x, self.n_padded, fill)
        return x[self.offset:self.offset + self.rows]

    def gather_sites(self, *arrays) -> tuple:
        """Every host array's rows (axis 0, ``rows`` each) gathered from
        the whole group, the padding sliced off: (E, ...) arrays, the same
        on every rank.  One ``all_gather`` of their bytes, whatever their
        number and types."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        for a in arrays:
            if a.shape[0] != self.rows:
                raise ValueError(f"gather_sites takes {self.rows} site rows "
                                 f"a rank, got shape {a.shape}")
        if self.group.world == 1:
            return tuple(a[:self.n_sites] for a in arrays)
        import torch.distributed as dist
        widths = [a[:1].nbytes for a in arrays]
        local = np.concatenate(
            [a.reshape(self.rows, -1).view(np.uint8) for a in arrays], axis=1)
        parts = [torch.empty(local.shape, dtype=torch.uint8)
                 for _ in range(self.group.world)]
        dist.all_gather(parts, torch.from_numpy(local), group=self.group.gloo)
        full = torch.cat(parts).numpy()[:self.n_sites]
        out, col = [], 0
        for a, w in zip(arrays, widths):
            rows = np.ascontiguousarray(full[:, col:col + w])
            out.append(rows.view(a.dtype).reshape((self.n_sites,)
                                                  + a.shape[1:]))
            col += w
        return tuple(out)

    def max_over_sites(self, x: torch.Tensor) -> torch.Tensor:
        """The max of one scalar over the group, on ``x``'s device.  The
        ranks' values are gathered and reduced with ``torch.amax``, so a
        NaN on any rank propagates as the unsharded max's does."""
        if self.group.world == 1:
            return x
        import torch.distributed as dist
        parts = [torch.empty((), dtype=x.dtype)
                 for _ in range(self.group.world)]
        dist.all_gather(parts, x.detach().cpu(), group=self.group.gloo)
        return torch.amax(torch.stack(parts)).to(x.device)


# ------------------------------------------------------------ the LM rules

# the active (mesh, rules): process-wide, not per thread, since autograd
# runs a CUDA backward (and recomputes a checkpointed block's forward) on
# a thread of its own, which must see the mesh the forward ran under
_state = types.SimpleNamespace(ctx=None)

# logical activation axis -> mesh axes (None = replicated)
ACTIVATION_RULES = {
    "batch": ("pod", "data"),
    "seq": None,            # overridden to "model" for SP in long-context cells
    "kv_seq": "model",      # sequence-parallel KV cache
    "heads": "model",
    "embed": None,
    "mlp": "model",
    "expert": "model",
    "vocab": "model",
}


def _active():
    """The active ``(mesh, rules)``, or None outside :func:`mesh_context`."""
    return _state.ctx


def active_mesh():
    """The active :class:`~repro_torch.launch.mesh.LMMesh`, or None."""
    ctx = _active()
    return None if ctx is None else ctx[0]


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` the active mesh of the model code run inside, with
    :data:`ACTIVATION_RULES` updated by ``rules`` and each rule's axes
    filtered to the mesh's (a mesh without ``"pod"`` batches over
    ``("data",)``)."""
    prev = _active()
    merged = dict(ACTIVATION_RULES)
    if rules:
        merged.update(rules)

    def _filter(v):
        if v is None:
            return None
        axes = (v,) if isinstance(v, str) else tuple(v)
        kept = tuple(a for a in axes if a in mesh.axis_names)
        return kept if kept else None
    _state.ctx = (mesh, {k: _filter(v) for k, v in merged.items()})
    try:
        yield
    finally:
        _state.ctx = prev


def rule_axes(name: str) -> tuple:
    """The mesh axes the active rules give logical axis ``name`` (empty
    outside a mesh)."""
    ctx = _active()
    if ctx is None or ctx[1].get(name) is None:
        return ()
    return ctx[1][name]


def logical_sharding_constraint(x, logical_axes):
    """The reference pins an activation's layout here; under the port's
    explicit SPMD the layers' own cuts fix it, so ``x`` comes back as it
    is."""
    return x


def shard_map_compat(f, *, mesh=None, in_specs=None, out_specs=None,
                     axis_names=None, check_vma=False):
    """The reference maps ``f`` over the local shards of ``axis_names``;
    every function of the port already runs on its rank's shard (the
    per-rank layers of ``models.layers`` and this module), so ``f`` is
    returned as it is."""
    return f


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _divisible(n: int, mesh, axis) -> bool:
    if axis is None:
        return False
    axes = (axis,) if isinstance(axis, str) else axis
    size = 1
    for a in axes:
        if a not in mesh.axis_names:
            return False
        size *= mesh.shape[a]
    return n % size == 0 and n >= size


def param_partition_spec(path: str, shape: tuple, mesh,
                         stacked: bool = False) -> tuple:
    """A parameter's layout: one mesh axis or None per dim, tensor
    parallelism over ``"model"`` and FSDP over ``"data"``, by its path
    (``jax.tree_util.keystr`` form) and global shape, as the reference
    lays it out; a dim that the axis does not divide is replicated.
    ``stacked``: the shape has a leading block axis (the reference's
    layout), which is never split."""
    core = shape[1:] if stacked else shape
    spec = _param_spec_core(path, core, mesh)
    if stacked:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def _d(n, mesh, axis):
    return axis if _divisible(n, mesh, axis) else None


def _param_spec_core(path: str, shape: tuple, mesh) -> tuple:
    m = mesh
    if re.search(r"(embed|lm_head)", path):
        # (vocab, d) — vocab over model, d over data (FSDP)
        return (_d(shape[0], m, "model"), _d(shape[1], m, "data"))
    if re.search(r"\bwq\b", path):         # (d, H, hd): heads over model
        return (_d(shape[0], m, "data"), _d(shape[1], m, "model"), None)
    if re.search(r"\bw[kv]\b", path):      # (d, KV, hd) — KV may be tiny
        return (_d(shape[0], m, "data"), _d(shape[1], m, "model"), None)
    if re.search(r"\bwo\b", path) and len(shape) == 3:  # (H, hd, d)
        return (_d(shape[0], m, "model"), None, _d(shape[2], m, "data"))
    if re.search(r"router", path):         # (d, E)
        return (None, _d(shape[1], m, "model"))
    if re.search(r"(moe|expert)", path) and len(shape) == 3:  # (E, d, f)
        return (_d(shape[0], m, "model"), _d(shape[1], m, "data"), None)
    if re.search(r"\bwi\b|\bwg\b", path) and len(shape) == 2:  # (d, f)
        return (_d(shape[0], m, "data"), _d(shape[1], m, "model"))
    if re.search(r"\bwo\b", path) and len(shape) == 2:         # (f, d)
        return (_d(shape[0], m, "model"), _d(shape[1], m, "data"))
    if re.search(r"in_proj|out_proj", path) and len(shape) == 2:
        return (_d(shape[0], m, "data"), _d(shape[1], m, "model")) \
            if "in_proj" in path else (_d(shape[0], m, "model"),
                                       _d(shape[1], m, "data"))
    if re.search(r"conv_w", path) and len(shape) == 2:         # (w, ch)
        return (None, _d(shape[1], m, "model"))
    # norms, biases, scalars: replicated
    return tuple(None for _ in shape)


def leaf_paths(tree, path: str = ""):
    """(path, leaf) of every leaf, the path as ``keystr`` writes it
    (``['layers'][0]['mixer']['wq']``), dict entries by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaf_paths(t, f"{path}[{i}]")
    else:
        yield path, tree


def map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` on every leaf, in a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, t, f"{path}[{i}]")
                          for i, t in enumerate(tree))
    return fn(path, tree)


def tree_pspecs(params, mesh, stacked_prefix: str = "blocks"):
    """The spec of every leaf, in a tree of ``params``' structure.  On the
    port's per-layer tree (``models.convert``'s layout: layer ``i`` is
    block ``i // period`` of period position ``i % period``) a leaf's spec
    is its reference leaf's without the block axis; on the reference's
    layout (``params_to_jax``) leaves under ``stacked_prefix`` are
    stacked."""
    return map_paths(lambda p, t: _spec(p, t, mesh, stacked_prefix), params)


def _spec(path: str, t, mesh, stacked_prefix: str) -> tuple:
    return param_partition_spec(path, tuple(t.shape), mesh,
                                stacked=stacked_prefix in path)


def flat_pspecs(params, mesh, stacked_prefix: str = "blocks") -> dict:
    """:func:`tree_pspecs` as a dict from each leaf's path to its spec."""
    return {p: _spec(p, t, mesh, stacked_prefix)
            for p, t in leaf_paths(params)}


def _drop(spec: tuple, axis: str) -> tuple:
    return tuple(None if ax == axis else ax for ax in spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's layout on this rank of ``mesh``."""

    mesh: object
    spec: tuple

    def dims(self, axes=None) -> list:
        """(dim, axis) of every split dim (along ``axes`` only, if
        given) whose axis has more than one rank."""
        return [(i, a) for i, a in enumerate(self.spec)
                if a is not None and self.mesh.size(a) > 1
                and (axes is None or a in axes)]

    def shard(self, t):
        """This rank's part of the whole leaf ``t``, a fresh tensor."""
        for i, a in self.dims():
            n = t.shape[i] // self.mesh.size(a)
            t = t.narrow(i, self.mesh.coord(a) * n, n)
        return t.clone()

    def gather(self, t, axes=None, differentiable: bool = False):
        """The shard ``t`` gathered whole along ``axes`` (all of them if
        None).  ``differentiable``: FSDP's gather, its gradient summed
        over the ranks and cut back (only along ``"data"``)."""
        from repro_torch.parallel import collectives as C
        if differentiable:
            dims = self.dims(("data",))
            return C.fsdp_gather(t, dims[0][0] if dims else None,
                                 self.mesh.group("data"))
        for i, a in self.dims(axes):
            t = C.all_gather(t, i, self.mesh.group(a))
        return t

    def owned(self, axes) -> bool:
        """Whether this rank counts the leaf once in a sum over the ranks
        of ``axes``: the leaf is split along each of them, or this rank is
        the first along those it is replicated over."""
        return all(self.mesh.coord(a) == 0 for a in axes
                   if a in self.mesh.axis_names and a not in self.spec)


def tree_shardings(params, mesh, stacked_prefix: str = "blocks"):
    """:class:`Sharding` of every leaf, in a tree of ``params``'
    structure."""
    return map_paths(
        lambda p, t: Sharding(mesh, _spec(p, t, mesh, stacked_prefix)),
        params)


def gathered_shardings(params, mesh, stacked_prefix: str = "blocks"):
    """ZeRO-3's forward layout: every leaf's spec with the FSDP
    (``"data"``) axis dropped and ``"model"`` kept, the layout the step's
    forward copy is gathered to."""
    return map_paths(
        lambda p, t: _drop(_spec(p, t, mesh, stacked_prefix), "data"),
        params)


def gather_block_constraint(tree, shards: "LMShards", prefix: str = ""):
    """Per-block ZeRO-3: one period block's shards (``tree``, at
    ``prefix`` in the parameter tree) gathered over ``"data"``, so the
    gathered working set is one block; the gradients are reduce-scattered
    back to the shards in the backward pass.  A leaf the rules leave whole
    (every leaf of fewer than two dims) passes as it is, and its gradient
    is all-reduced over ``"data"``."""
    return map_paths(
        lambda path, t: shards.at(path).gather(t, differentiable=True),
        tree, prefix)


@dataclasses.dataclass(eq=False)
class LMShards:
    """The layout of one parameter tree (the port's per-layer tree) on an
    :class:`~repro_torch.launch.mesh.LMMesh`: every leaf's
    :class:`Sharding`, from the tree's global shapes (:meth:`of`).  The
    masters, the moments and the gradients are held as this rank's
    shards; the forward reads the tree gathered over ``"data"`` and split
    over ``"model"``."""

    mesh: object
    specs: dict          # path -> spec

    @classmethod
    def of(cls, params, mesh) -> "LMShards":
        """The layout of ``params`` (whole leaves, or meta tensors of the
        whole shapes)."""
        return cls(mesh, flat_pspecs(params, mesh))

    @classmethod
    def for_config(cls, cfg, mesh) -> "LMShards":
        from repro_torch.models.transformer import init_params
        return cls.of(init_params(cfg, None, device="meta"), mesh)

    def at(self, path: str) -> Sharding:
        return Sharding(self.mesh, self.specs[path])

    def shard(self, tree):
        """This rank's shards of a tree of whole leaves."""
        return map_paths(lambda p, t: self.at(p).shard(t), tree)

    def gather(self, tree, axes=None):
        """Every shard gathered whole (along ``axes`` only, if given)."""
        return map_paths(lambda p, t: self.at(p).gather(t, axes), tree)

    def reduce_grads(self, grads, axes: tuple, scattered=lambda p: False):
        """The gradients of this rank's tokens (whole along ``"data"``,
        or already shards where ``scattered(path)``) summed over the
        batch ``axes`` and cut to this rank's shards, in f32: a
        reduce-scatter over ``"data"`` for a leaf split along it (an
        all-reduce for one replicated over it), then an all-reduce over
        ``"pod"``."""
        from repro_torch.parallel import collectives as C
        mesh = self.mesh

        def one(path, g):
            g = g.to(torch.float32)
            sh = self.at(path)
            if "data" in axes and not scattered(path):
                dims = sh.dims(("data",))
                g = (C.reduce_scatter(g, dims[0][0], mesh.group("data"))
                     if dims else C.all_reduce(g, mesh.group("data")))
            if "pod" in axes:
                g = C.all_reduce(g, mesh.group("pod"))
            return g
        return map_paths(one, grads)

    def inpod_axes(self) -> tuple:
        return tuple(a for a in ("data", "model") if a in self.mesh.axis_names)

    def owned(self, path: str) -> bool:
        return self.at(path).owned(self.inpod_axes())

    def sum_inpod(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over this rank's pod (its ``data`` x ``model``
        ranks)."""
        from repro_torch.parallel import collectives as C
        return C.all_reduce(x, self.mesh.group(self.inpod_axes()))

    def local_batch(self, batch: dict, microbatches: int = 1,
                    pod_region: bool = False) -> dict:
        """This rank's rows of a global batch, as the reference's
        ``put_batch`` splits it over ``("pod", "data")`` and its step cuts
        the microbatches: microbatch ``i`` of the whole batch is split
        over the pod and data ranks, so each rank's ``i``-th microbatch
        is its part of the whole batch's.  ``pod_region``: the batch is
        first cut into the pods (the exchange's pod axis), then each
        pod's microbatches over its data ranks."""
        mesh = self.mesh
        P, D = mesh.size("pod"), mesh.size("data")
        p, d = mesh.coord("pod"), mesh.coord("data")
        n = microbatches

        def cut(x):
            b = x.shape[0]
            if b % (P * D * n):
                raise ValueError(f"batch {b} does not split into {P} pod(s) "
                                 f"x {D} data rank(s) x {n} microbatch(es)")
            r = b // (P * D * n)
            x = x.reshape((P, n, D, r) + tuple(x.shape[1:])) if pod_region \
                else x.reshape((n, P * D, r) + tuple(x.shape[1:]))
            x = x[p, :, d] if pod_region else x[:, p * D + d]
            return x.reshape((n * r,) + tuple(x.shape[2:]))
        return {k: cut(v) for k, v in batch.items()}


# (config, mesh) -> LMShards: the layout of a config's tree on a mesh
_LM_SHARDS: dict = {}


def lm_shards(cfg, mesh) -> LMShards:
    """The layout of ``cfg``'s parameter tree on ``mesh`` (made once a
    pair)."""
    key = (cfg, id(mesh))
    hit = _LM_SHARDS.get(key)
    if hit is None or hit.mesh is not mesh:
        hit = _LM_SHARDS[key] = LMShards.for_config(cfg, mesh)
    return hit
