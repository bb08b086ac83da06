"""Checkpoints of the scan runtime's carry and of training states, with
atomic manifests — port of ``repro.ckpt.checkpoint`` over the port's
dataclass states.

Format (the reference's): one directory per step holding
  manifest.json   — step, leaf paths, shapes, dtypes, save-complete marker
  data.npz        — the flattened leaves, keyed by their tree paths

A leaf's key is its path as ``jax.tree_util.keystr`` writes it for the
reference's pytrees: ``.name`` for a dataclass field, ``['q']`` for a
dict entry, ``[i]`` for a list or tuple item (``.window_id``,
``.controller.demand``, ``.chaos.served['AVG']``,
``.params['blocks'][0]['mixer']['wq']``); ``None`` holds no leaves, and
an int leaf (``window_id``, a training state's ``step``) is saved as an
int32 0-d array.  A checkpoint written by either package therefore
restores into the other.  A training state is saved in the reference's
stacked layout (``models.convert.train_state_to_jax``).

Atomicity: a save writes ``<dir>/.tmp-<step>-<pid>`` and renames it, so a
crashed save never shadows the previous good checkpoint; the next save
removes staging directories whose writer has died.

Placement: :func:`restore` loads the leaves on the host and moves them to
an explicit ``device`` (the reference takes shardings; the port runs on
one device).  ``CheckpointManager(async_save=True)`` copies the state to
the host, then writes on a worker thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _leaves(tree, path: str = ""):
    """(key, leaf) pairs of a state in the reference's flattening order:
    dataclass fields in order, dict entries by sorted key, sequence items
    in order, None skipped."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (never a view: the runtime updates its state
    in place, and a CPU tensor's ``numpy()`` shares its memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(
            leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.int32)       # the window cursor
    return np.array(leaf)


def flatten(state) -> dict:
    """{key: host array} of every leaf, keyed as the checkpoint keys it."""
    return {k: _host(v) for k, v in _leaves(state)}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True               # exists, owned by someone else
    return True


def _gc_orphan_tmp(directory: Path) -> None:
    """Remove ``.tmp-*`` staging directories left by crashed savers.

    Each name carries its writer's pid: directories whose writer is dead
    (or whose name carries no pid) go; this process's and live writers'
    stay.
    """
    for d in directory.glob(".tmp-*"):
        if not d.is_dir():
            continue
        parts = d.name.split("-")
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            shutil.rmtree(d, ignore_errors=True)   # name without a pid
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        shutil.rmtree(d, ignore_errors=True)


def _write(flat: dict, step: int, directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    _gc_orphan_tmp(directory)
    tmp = directory / f".tmp-{step}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "data.npz", **flat)
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "time": time.time(),
        "complete": True,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    final = directory / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(state, step: int, directory: str | Path) -> Path:
    """Write ``state`` (a :class:`~repro_torch.runtime.state.RuntimeState`
    or any tree of dataclasses, dicts, sequences and arrays) as
    checkpoint ``step``."""
    return _write(flatten(state), step, Path(directory))


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest complete step in ``directory``; a torn manifest counts
    as absent."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            try:
                m = json.loads((d / "manifest.json").read_text())
                if m.get("complete"):
                    steps.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    return max(steps) if steps else None


def _rebuild(template, data, device, path: str = ""):
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _rebuild(getattr(template, f.name), data, device,
                             f"{path}.{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, data, device, f"{path}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, data, device, f"{path}[{i}]")
                              for i, t in enumerate(template))
    arr = data[path]
    shape = tuple(template.shape) if hasattr(template, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch restoring {path}: "
                         f"{arr.shape} vs {shape}")
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(arr), device=device).to(template.dtype)
    if isinstance(template, (int, np.integer)):
        return int(arr)
    return np.asarray(arr, np.asarray(template).dtype)


def restore(directory: str | Path, step: int, abstract_state, device=None):
    """Load checkpoint ``step`` into the structure of ``abstract_state``
    (its leaves give shapes and dtypes; their values are ignored), with
    every tensor leaf on ``device`` (None: the GPU)."""
    d = Path(directory) / f"step_{step:08d}"
    with np.load(d / "data.npz") as data:
        return _rebuild(abstract_state, data, resolve_device(device))


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writer thread,
    whose failure the next :meth:`wait` (or save, or :meth:`latest`)
    raises."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, state, step: int):
        # the host copy is taken now: the runtime updates its state in place
        flat = flatten(state)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_in_background, args=(flat, step),
                daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(flat, step)

    def _save_and_gc(self, flat: dict, step: int):
        _write(flat, step, self.directory)
        kept = sorted(d for d in self.directory.iterdir()
                      if d.name.startswith("step_"))
        for d in kept[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    def _save_in_background(self, flat: dict, step: int):
        try:
            self._save_and_gc(flat, step)
        except Exception as exc:        # raised again by wait()
            self._error = exc

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, abstract_state, device=None,
                step: Optional[int] = None):
        """(state, step) of ``step`` (default the newest), or (None, None)
        when there is none."""
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return restore(self.directory, step, abstract_state, device), step


def save_train_state(manager: Optional[CheckpointManager], state, step: int,
                     cfg, shards=None) -> None:
    """Save a training state (the port's per-layer ``TrainState``) as
    checkpoint ``step`` in the reference's stacked layout.  ``shards``
    (``parallel.sharding.LMShards``): the state is this rank's shards;
    every rank of the mesh calls this, each leaf is gathered whole and
    moved to the host one at a time, and the rank that holds ``manager``
    (rank 0; the others pass None) writes it, so the file is the one an
    unsharded run writes."""
    from repro_torch.models.convert import train_state_to_jax
    from repro_torch.optim.adamw import TrainState
    if shards is not None:
        from repro_torch.parallel.sharding import map_paths

        def whole(tree):
            return map_paths(lambda p, t: shards.at(p).gather(t).cpu(), tree)
        state = TrainState(params=whole(state.params), m=whole(state.m),
                           v=whole(state.v), step=state.step)
    if manager is not None:
        manager.save(train_state_to_jax(state, cfg), step)


def restore_train_state(manager: CheckpointManager, cfg, device=None,
                        shards=None, step: Optional[int] = None):
    """(training checkpoint ``step`` (default the newest) as the port's
    ``TrainState`` on ``device``, its step), or (None, None).
    ``shards``: each leaf is cut to this rank's shard of the mesh it
    restores onto, whatever mesh saved it (a checkpoint holds whole
    leaves)."""
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_template)
    from repro_torch.optim.adamw import TrainState
    saved, step = manager.restore(train_state_template(cfg), device="cpu",
                                  step=step)
    if saved is None:
        return None, None
    host = train_state_from_jax(saved, cfg)
    dev = resolve_device(device)

    def placed(tree):
        if shards is not None:
            tree = shards.shard(tree)
        from repro_torch.optim.adamw import tree_map
        return tree_map(lambda t: t.to(dev), tree)
    return TrainState(params=placed(host.params), m=placed(host.m),
                      v=placed(host.v), step=host.step), step
