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

The reference's LM rules in its file (``ACTIVATION_RULES``,
``mesh_context``, ``param_partition_spec``, ``tree_pspecs``,
``gather_block_constraint`` ...) belong to the LM stack and are not
ported here.
"""
from __future__ import annotations

import dataclasses
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
