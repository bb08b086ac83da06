"""ShardedScanRuntime — the whole window step on the site group.

Port of ``repro.runtime.sharded``.  The reference wraps its scan in
``shard_map`` over a 1-D ``("sites",)`` device mesh; the port runs the
scan runtime's loop on every rank of a ``torch.distributed`` group, each
over its own rows of the fleet (:class:`~repro_torch.parallel.SiteShard`):
the pool, the carry (controller, totals, the adaptive and chaos carries)
and the liveness mask.  With no process group the world size is 1 and
the one rank holds every row.

Padding
    E is rounded up to a multiple of the world size (``pad_sites``
    overrides it).  The extra rows are permanently dead sites in the
    liveness mask chaos faults use
    (:func:`~repro_torch.chaos.padded_liveness_table`), so the step always
    runs its ``chaos=True`` body and every dead-site guarantee (zero
    budget, zero bytes, frozen EWMAs, no ingest) covers padding.

Collectives (host tensors over gloo)
    one gather of the (E,) demand and liveness a window under the
    rebalance controller (the water-fill runs over exactly E sites); one
    max of the drift gate's deviation a window on adaptive runs; one
    gather of the outputs and the final state at the end.  Static
    budgets need none inside the loop.

Parity
    A sharded run is bitwise the port's unsharded scan at any world
    size: counters, budgets, floats and the final state.  Each rank draws
    the whole fleet's sampling uniforms and keeps its rows, the one-site
    fit is chosen by the fleet's site count, and the water-fill sums in
    the unsharded order.  Every rank returns the same report, and
    ``final_state`` is unpadded, so checkpoints interchange with
    ``runtime="scan"`` in both directions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import SiteShard, site_group, site_pad
from repro_torch.planning.batched import BatchedEngine
from repro_torch.runtime.scan import ScanRuntime
from repro_torch.runtime.state import RuntimeState


def _map_tensors(fn, obj):
    """``obj`` (a carry: dataclasses and dicts of tensors) with ``fn``
    applied to every tensor, in field order."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {key: _map_tensors(fn, v) for key, v in obj.items()}
    return obj


@dataclasses.dataclass
class ShardedScanRuntime(ScanRuntime):
    """The scan runtime with the fleet's sites split over the site group.

    ``pad_sites`` overrides the padded site count (tests check padding
    invariance with it); None pads E to the world size's multiple.
    """

    pad_sites: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        if self.topology is None:
            raise ValueError(
                "runtime='scan_sharded' shards the fleet site axis; a "
                "single edge has nothing to shard (use runtime='scan')")
        if self.n_sites < 2:
            raise ValueError(
                "runtime='scan_sharded' needs a fleet of >= 2 sites "
                "(single-site fleets sample through the host-parity chain "
                "the sharded sampler does not replicate)")
        group = site_group()
        e = self.n_sites
        e_pad = (int(self.pad_sites) if self.pad_sites is not None
                 else e + site_pad(e, group.world))
        if e_pad < e or e_pad % group.world:
            raise ValueError(
                f"pad_sites ({e_pad}) must be >= n_sites ({e}) and a "
                f"multiple of the {group.world}-rank site group")
        self.shard = SiteShard(group, e, e_pad)
        self._rows = self.shard.rows

    def _plan_fn(self, values, counts, budgets):
        # this runtime is the sharded engine hoisted around the whole
        # step: its rows plan through the batched pass even when the
        # scenario names engine='sharded'
        return BatchedEngine.run(self.engine, values, counts, budgets,
                                 self.cfg_eff, use_kernel=self.use_kernel,
                                 n_static=self._n_static(values),
                                 n_sites=self.n_sites)

    def _step_exec(self, static_exec):
        if static_exec is None:
            return None
        return self.shard.local_rows(np.asarray(static_exec))

    def _adopt_state(self, state: RuntimeState) -> RuntimeState:
        """A full (E-row) state, such as a checkpoint, as this rank's rows
        (padded rows zero: they are dead, so no live output reads them)."""
        def local(t):
            t = t.to(self.device)
            return self.shard.local_rows(t) if t.dim() else t
        return _map_tensors(local, state)

    def _step_liveness(self, live_tbl, T: int, w0: int) -> np.ndarray:
        from repro_torch.chaos import padded_liveness_table
        spec = self.chaos if self._chaos_active else None
        full = padded_liveness_table(spec, T, self.n_sites,
                                     self.shard.n_padded,
                                     self.topology.region_of(),
                                     first_window=w0)
        lo = self.shard.offset
        return np.ascontiguousarray(full[:, lo:lo + self.shard.rows])

    def _step_pool(self, pool_np: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.moveaxis(
            self.shard.local_rows(np.moveaxis(pool_np, 1, 0)), 0, 1))

    def _step_kwargs(self) -> dict:
        return {"shard": self.shard}

    def _finalize(self, ys, state, live_tbl):
        """Gather every output and the carry's site rows to the unpadded
        fleet on every rank (one gather).  When no real chaos ran, drop
        the all-live mask and the chaos carry: the report and the
        checkpoint are then a ``runtime="scan"`` run's."""
        # (T, rows, ...) outputs, by key and query
        flat = [(key, q, a) for key, val in ys.items()
                for q, a in (val.items() if isinstance(val, dict)
                             else [(None, val)])]
        leaves = []
        _map_tensors(lambda t: leaves.append(t) or t, state)
        rows = [t for t in leaves if t.dim()]
        full = self.shard.gather_sites(
            *[np.moveaxis(a, 1, 0) for _, _, a in flat],
            *[t.cpu().numpy() for t in rows])
        out = {}
        for (key, q, _), a in zip(flat, full):
            a = np.ascontiguousarray(np.moveaxis(a, 0, 1))
            if q is None:
                out[key] = a
            else:
                out.setdefault(key, {})[q] = a
        rest = iter(full[len(flat):])
        state = _map_tensors(
            lambda t: (torch.as_tensor(next(rest), device=t.device)
                       if t.dim() else t), state)
        if not self._chaos_active:
            out.pop("live", None)
            state.chaos = None
        return out, state, live_tbl
