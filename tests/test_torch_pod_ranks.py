"""The rank route of the cross-pod gradient exchange on gloo ranks on the
CPU, held to the stacked exchange in one process.

JAX-free: the ranks import this module by name.  One subprocess spawns
two ranks (``torch.multiprocessing``, the spawn method) on a gloo group;
each rank is one pod: starcoder2 smoke in f32 from the same seeded
parameters, its pod's half of each batch, ``make_train_step`` with
``make_grad_exchange`` and ``n_pods=1``, a first step from full sync and
a second with a plan that skips every third stream (the momentum then
non-zero), and writes its parameters and telemetry after each step.  The
same two steps here, with ``make_stacked_exchange`` and ``n_pods=2`` on
the whole batch: the parameters bitwise on both ranks, the telemetry
within f32 rtol 1e-6.
"""
import datetime
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "starcoder2-3b"
B, S, LR = 4, 16, 1e-3
WORLD = 2
RUN_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 120


def _cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")


def _state():
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    return adamw_init(init_params(_cfg(), torch.Generator().manual_seed(7)))


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        toks = rng.integers(0, _cfg().vocab, (B, S + 1))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        b["labels"][1, :3] = -1
        out.append(b)
    return out


def _plans(params):
    """Step 1 syncs every stream, step 2 skips every third."""
    from repro_torch.optim import ExchangePlan, full_sync_plan
    keys = list(full_sync_plan(params, _cfg()).sync)
    return [ExchangePlan(sync={k: True for k in keys}),
            ExchangePlan(sync={k: i % 3 != 2 for i, k in enumerate(keys)})]


def _lr():
    from repro_torch.optim import cosine_schedule
    return cosine_schedule(LR, 0, 10)


def _record(state, metrics, prefix: str) -> dict:
    from repro_torch.optim import tree_leaves
    out = {f"{prefix}param{i}": p.detach().numpy().copy()
           for i, p in enumerate(tree_leaves(state.params))}
    for k in ("pod_disagreement", "pod_magnitude", "grad_norm"):
        out[f"{prefix}{k}"] = metrics[k].numpy().copy()
    return out


def rank_steps(group=None) -> dict:
    """This rank's two steps on its pod's half of each batch."""
    import torch.distributed as dist
    from repro_torch.launch import make_train_step
    from repro_torch.optim import make_grad_exchange
    rank = dist.get_rank()
    state = _state()
    out = {}
    for i, (plan, batch) in enumerate(zip(_plans(state.params), _batches())):
        half = {k: v[rank * B // WORLD:(rank + 1) * B // WORLD]
                for k, v in batch.items()}
        step = make_train_step(
            _cfg(), _lr(), grad_exchange=make_grad_exchange(
                plan, group=group, cfg=_cfg()), n_pods=1)
        state, metrics = step(state, half)
        out.update(_record(state, metrics, f"step{i + 1}/"))
    return out


def stacked_steps() -> dict:
    """The same two steps in one process: both pods, the stacked
    exchange."""
    from repro_torch.launch import make_train_step
    from repro_torch.optim import make_stacked_exchange
    state = _state()
    out = {}
    for i, (plan, batch) in enumerate(zip(_plans(state.params), _batches())):
        step = make_train_step(
            _cfg(), _lr(), grad_exchange=make_stacked_exchange(
                plan, cfg=_cfg()), n_pods=WORLD)
        state, metrics = step(state, batch)
        out.update(_record(state, metrics, f"step{i + 1}/"))
    return out


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        np.savez(f"{out_dir}/rank{rank}.npz", **rank_steps())
    finally:
        dist.destroy_process_group()


def launch(world: int, out_dir: str) -> None:
    """Spawn ``world`` gloo ranks; raises if a rank fails."""
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(world, out_dir), nprocs=world, join=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pods")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    prog = f"import {__name__} as m; m.launch({WORLD}, {str(out)!r})"
    # a session of its own: a timeout kills the ranks with it
    proc = subprocess.Popen(
        [sys.executable, "-c", prog], cwd=pathlib.Path(__file__).parent,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise
    assert proc.returncode == 0, log[-4000:]
    got = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as data:
            got.append(dict(data))
    return got


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_rank_route_is_the_stacked_step(ranks, rank):
    want = stacked_steps()
    got = ranks[rank]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if "/param" in name:
            assert np.array_equal(got[name], w), name
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=0,
                                       err_msg=name)
    # the second plan skipped streams: their telemetry is 0 on both sides
    assert (want["step2/pod_magnitude"] == 0).sum() == \
        len(_plans(_state().params)[1].sync) // 3


def test_the_rank_route_sends_only_the_synced_streams():
    """``synced_bytes``: what a rank all-reduces a step under a plan and
    under full sync."""
    from repro_torch.optim import synced_bytes, tree_leaves
    state = _state()
    full, skip = _plans(state.params)
    total = sum(4 * p.numel() for p in tree_leaves(state.params))
    assert synced_bytes(full, state.params, _cfg()) == (total, total)
    sent, all_bytes = synced_bytes(skip, state.params, _cfg())
    assert all_bytes == total and 0 < sent < total
