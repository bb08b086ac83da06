"""Sharded fleet planning: the batched (E, k, N) pass split over the
ranks of the site group — port of ``repro.planning.sharded``.

Every per-site quantity of the plan (statistics, model fit, epsilon, the
closed-form allocation) depends only on that site's window and budget, so
each rank plans its own rows (:class:`~repro_torch.parallel.SiteShard`)
with the batched pass and the rows are gathered to the whole fleet on
every rank.  E is padded up to a multiple of the world size with empty
sites (counts 0, budget 2.0) and the padding is sliced off the result.
The one-site fit is chosen by the fleet's site count, never by a shard's
row count, so a plan is bitwise the batched engine's at any world size.
With no process group (world size 1) this is the batched engine itself.
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import ENGINES
from repro_torch.parallel.sharding import SiteShard, site_group, site_pad
from repro_torch.planning.batched import BatchedEngine, FleetPlan


class ShardedEngine(BatchedEngine):
    """The batched pass over this rank's rows of the fleet, gathered.
    ``plan_fleet`` (the event loop) is the batched engine's, through
    :meth:`run`."""

    name = "sharded"

    def run(self, values, counts, budgets, cfg, *, use_kernel=None,
            n_static=None, n_sites=None):
        group = site_group()
        if group.world == 1:
            return super().run(values, counts, budgets, cfg,
                               use_kernel=use_kernel, n_static=n_static,
                               n_sites=n_sites)
        e = values.shape[0]
        shard = SiteShard(group, e, e + site_pad(e, group.world))
        plan = super().run(
            shard.local_rows(values), shard.local_rows(counts),
            shard.local_rows(budgets, fill=2.0), cfg, use_kernel=use_kernel,
            n_static=n_static, n_sites=e if n_sites is None else n_sites)
        rows = plan.to_numpy()
        return FleetPlan(**{
            name: torch.as_tensor(a, device=values.device)
            for name, a in zip(rows, shard.gather_sites(*rows.values()))})


ENGINES.register("sharded", ShardedEngine())
