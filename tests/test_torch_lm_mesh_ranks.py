"""One sharded train step on gloo ranks on the CPU (FSDP over ``data``,
tensor parallelism over ``model``, pods with the exchange) against the
port's unsharded step on the same batch.

JAX-free: the ranks import this module by name.  One subprocess a world
size spawns the ranks (``torch.multiprocessing``, the spawn method); each
rank runs every case of its world size in turn, each on a mesh of its
own, and rank 0 writes the loss, the grad norm, the gradients gathered
whole and the parameters after the step.  The reference's mesh path does
not run on this container's jax (ROADMAP queue 3, note c), so the
unsharded port is the oracle, as site sharding was held in
``test_torch_sharded_ranks.py``.

Limits.  In f64 (every f32 of the model read as f64, as
``scripts/lm_grad_probe.py`` widens it) the loss, every gradient leaf and
every updated parameter leaf are within 1e-10 of the leaf's largest
magnitude: the same function, up to the order of the sums the ranks
split.  In f32 the gradients are within the families' card-against-CPU
limits (1e-3 of a leaf's largest magnitude, 2e-3 for gemma3), the loss
within 1e-5 relative, and each updated parameter within 2 lr (a sign
flip of a near-zero gradient moves a parameter by 2 lr); the forward
copy gathered over ``data`` is the unsharded tree bitwise.
"""
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, LR = 4, 16, 1e-3
RUN_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120

# (arch, (pods, data, model), precision, options); options: "exchange"
# (pods are the exchange's, full sync), "zero3", "micro" (microbatches)
CASES = {
    2: [("starcoder2-3b", (1, 2, 1), "f64", {}),
        ("starcoder2-3b", (1, 1, 2), "f64", {}),
        ("gemma3-12b", (1, 1, 2), "f64", {}),
        ("qwen3-moe-30b-a3b", (1, 2, 1), "f64", {}),
        ("deepseek-moe-16b", (1, 1, 2), "f64", {}),
        ("mamba2-780m", (1, 2, 1), "f64", {}),
        ("whisper-large-v3", (1, 2, 1), "f64", {}),
        ("starcoder2-3b", (1, 2, 1), "f32", {}),
        ("starcoder2-3b", (1, 1, 2), "f32", {}),
        ("gemma3-12b", (1, 1, 2), "f32", {})],
    4: [("starcoder2-3b", (2, 1, 2), "f64", {"exchange": True}),
        ("starcoder2-3b", (1, 1, 4), "f64", {}),
        ("qwen3-moe-30b-a3b", (1, 2, 2), "f64",
         {"zero3": "block", "micro": 2}),
        ("yi-9b", (2, 2, 1), "f64", {})],
}


def case_id(case) -> str:
    arch, mesh, prec, opt = case
    return "-".join([arch.split("-")[0], "x".join(map(str, mesh)), prec]
                    + [f"{k}{v}" for k, v in sorted(opt.items())])


def _load_probe():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lm_grad_probe", ROOT / "scripts" / "lm_grad_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every f32 of the port's LM stack read as f64
widened = _load_probe().widened


def _cfg(arch: str, opt: dict):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if "zero3" in opt:
        cfg = dataclasses.replace(cfg, zero3=opt["zero3"])
    return cfg


def _batch(cfg) -> dict:
    from repro_torch.launch.train import random_stub_inputs
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1         # the ranks hold unequal counts
    batch["labels"][3, -2:] = -1
    batch.update(random_stub_inputs(cfg, B, rng))
    return batch


def _params(cfg):
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(3))


def _plan(cfg):
    from repro_torch.optim import full_sync_plan
    from repro_torch.models import init_params
    return full_sync_plan(init_params(cfg, None, device="meta"), cfg)


def _host(tree) -> list:
    from repro_torch.optim import tree_leaves
    return [t.detach().to(torch.float64).numpy().copy()
            for t in tree_leaves(tree)]


def run_sharded(case) -> dict:
    """This rank's step of ``case`` on a mesh over the whole group; the
    gradients and parameters gathered whole."""
    from repro_torch.launch import make_train_step
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.optim import make_grad_exchange, tree_leaves
    from repro_torch.parallel.sharding import lm_shards, mesh_context
    arch, sizes, prec, opt = case
    with widened(prec == "f64"):
        cfg = _cfg(arch, opt)
        mesh = build_mesh(("pod", "data", "model"), sizes)
        shards = lm_shards(cfg, mesh)
        full = _params(cfg)
        state = adamw_init(shards.shard(full))
        # the forward copy over "data" against the unsplit tree, bitwise
        fsdp_bitwise = all(
            torch.equal(x, y) for x, y in zip(
                tree_leaves(shards.gather(shards.gather(
                    state.params, ("data",)), ("model",))),
                tree_leaves(full)))
        ex = None
        if opt.get("exchange"):
            ex = make_grad_exchange(_plan(cfg), group=mesh.group("pod"),
                                    cfg=cfg, shards=shards)
        step = make_train_step(cfg, cosine_schedule(LR, 0, 10),
                               microbatches=opt.get("micro", 1),
                               grad_exchange=ex)
        local = shards.local_batch(_batch(cfg), opt.get("micro", 1),
                                   pod_region=ex is not None)
        local = {k: torch.as_tensor(v) for k, v in local.items()}
        with mesh_context(mesh):
            loss, metrics, grads = step.loss_and_grads(state, local)
            g = _host(shards.gather(grads))
            state, metrics = step.apply(state, grads, loss, metrics)
            p = _host(shards.gather(state.params))
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "grads": g, "params": p, "fsdp_bitwise": fsdp_bitwise}


def run_unsharded(case) -> dict:
    """The same step in one process, no mesh: the pods stacked, the MoE
    dispatched in as many groups as the case's batch ranks."""
    from repro_torch.launch import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.optim import (adamw_init, cosine_schedule,
                                   make_stacked_exchange)
    arch, (pods, data, _), prec, opt = case
    with widened(prec == "f64"):
        cfg = _cfg(arch, opt)
        state = adamw_init(_params(cfg))
        ex = make_stacked_exchange(_plan(cfg), cfg=cfg) \
            if opt.get("exchange") else None
        step = make_train_step(cfg, cosine_schedule(LR, 0, 10),
                               microbatches=opt.get("micro", 1),
                               grad_exchange=ex, n_pods=pods)
        groups = data if opt.get("exchange") else pods * data
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
        with L.dispatch_groups(groups):
            loss, metrics, grads = step.loss_and_grads(state, batch)
            g = _host(grads)
            state, metrics = step.apply(state, grads, loss, metrics)
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "grads": g, "params": _host(state.params)}


# the tensor-parallel prefill: (arch, precision) on two model ranks
PREFILL = [("gemma3-12b", "f64"), ("starcoder2-3b", "f64"),
           ("gemma3-12b", "f32")]
MAX_SEQ = 24


def run_prefill(arch: str, prec: str, mesh=None) -> dict:
    """A prompt's prefill (last logits, each layer's ring) and the full
    forward's logits of a smoke model built from the seeded parameters,
    on ``mesh``'s model ranks (None: unsplit)."""
    from repro_torch.models import Transformer
    with widened(prec == "f64"):
        cfg = _cfg(arch, {})
        model = Transformer(cfg, _params(cfg), device="cpu", mesh=mesh)
        batch = {"tokens": _batch(cfg)["tokens"]}
        with torch.no_grad():
            last, cache = model.prefill(batch, MAX_SEQ)
            full = model(batch)
        return {"last": last.double().numpy(), "full": full.double().numpy(),
                "ring_heads": [c["k"].shape[2] for c in cache["layers"]],
                "ring_k0": cache["layers"][0]["k"].double().numpy()}


def _rank(rank: int, world: int, out_dir: str) -> None:
    import datetime
    import pickle
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = {case_id(c): run_sharded(c) for c in CASES[world]}
        if world == 2:
            from repro_torch.launch.mesh import build_mesh
            mesh = build_mesh(("data", "model"), (1, 2))
            for arch, prec in PREFILL:
                got = run_prefill(arch, prec, mesh)
                from repro_torch.parallel.collectives import all_gather
                # the rings' heads of both ranks, in head order
                got["ring_k0"] = all_gather(torch.from_numpy(got["ring_k0"]),
                                            2, mesh.group("model")).numpy()
                out[f"prefill-{arch}-{prec}"] = got
        if rank == 0:
            with open(f"{out_dir}/rank0.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch(world: int, out_dir: str) -> None:
    """Spawn ``world`` gloo ranks; raises if a rank fails."""
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(world, out_dir), nprocs=world, join=True)


def spawn(world: int, out: pathlib.Path, module: str) -> None:
    """``module.launch(world, out)`` in a subprocess of its own session (a
    timeout kills the ranks with it), from ``tests/``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    prog = f"import {module} as m; m.launch({world}, {str(out)!r})"
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


def _spawned(world: int, tmp_path_factory) -> dict:
    import pickle
    out = tmp_path_factory.mktemp(f"mesh{world}")
    spawn(world, out, __name__)
    with open(out / "rank0.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawned(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawned(4, tmp_path_factory)


def _rel(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("case", [c for w in sorted(CASES) for c in CASES[w]],
                         ids=case_id)
def test_the_sharded_step_is_the_unsharded_step(request, case):
    arch, sizes, prec, opt = case
    world = int(np.prod(sizes))
    got = request.getfixturevalue(f"ranks{world}")[case_id(case)]
    want = run_unsharded(case)
    if prec == "f64":
        tol = 1e-10
        assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            tol * want["grad_norm"]
        for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
            assert _rel(a, b) <= tol, (i, _rel(a, b))
        for i, (a, b) in enumerate(zip(got["params"], want["params"])):
            assert _rel(a, b) <= tol, (i, _rel(a, b))
        return
    limit = 2e-3 if arch.startswith("gemma3") else 1e-3
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
        assert _rel(a, b) <= limit, (i, _rel(a, b))
    for a, b in zip(got["params"], want["params"]):
        assert float(np.abs(a - b).max()) <= 2 * LR
    if sizes[2] == 1:
        assert got["fsdp_bitwise"]


@pytest.mark.parametrize("arch,prec", PREFILL)
def test_the_model_parallel_prefill_is_the_unsplit_prefill(ranks2, arch,
                                                           prec):
    """Each rank runs its heads and its vocabulary rows (its rings hold its
    KV heads); the last and full logits are the unsplit model's within
    1e-10 of their largest magnitude in f64 and 1e-3 in f32 (the dense
    models' f32 end-to-end limit, ``test_torch_lm_model.py``), and the two
    ranks' rings are the unsplit rings."""
    got, want = ranks2[f"prefill-{arch}-{prec}"], run_prefill(arch, prec)
    tol = 1e-10 if prec == "f64" else 1e-3
    for k in ("last", "full", "ring_k0"):
        assert got[k].shape == want[k].shape
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
    kv = _cfg(arch, {}).n_kv
    assert got["ring_heads"] == [kv // 2] * len(want["ring_heads"])
    assert want["ring_heads"] == [kv] * len(want["ring_heads"])


# ------------------------------------------------------------- the driver

EXCHANGE = ["--pods", "2", "--edge-exchange", "--exchange-window", "3",
            "--dcn-budget", "0.4", "--steps", "6", "--batch", "8", "--seq",
            "32", "--log-every", "3"]


def test_driver_pods_on_ranks_are_the_stacked_driver(capfd):
    """``--host-devices 2 --pods 2 --edge-exchange``: each rank a pod of
    the mesh (pod 2, data 1, model 1), the exchange over the pod group;
    every loss, grad norm, sync fraction and replan is the one-process
    stacked driver's."""
    from repro_torch.launch.train import main
    ranks, alone = {}, {}
    main(["--host-devices", "2"] + EXCHANGE, stats=ranks)
    out = capfd.readouterr().out
    main(EXCHANGE + ["--device", "cpu"], stats=alone)
    assert "mesh={'pod': 2, 'data': 1, 'model': 1}" in out
    assert ranks["mesh"] == {"pod": 2, "data": 1, "model": 1}
    for k in ("loss", "grad_norm", "sync_fraction", "replanned_at"):
        assert ranks[k] == alone[k], k
    assert ranks["replanned_at"] == [3, 6]


def test_a_data_mesh_run_resumes_on_a_data_and_model_mesh(tmp_path, capfd):
    """Saved on (data 2) at step 4, resumed on (data 2, model 2): the run
    restores step 4 and its first step's loss and grad norm are the
    unsplit step's from the checkpoint on batch 5 (f32: rtol 1e-5 and
    1e-3, the card-against-CPU limits of ``chip_smoke.TRAIN``).  A
    checkpoint holds whole leaves: its file is the one an unsplit run
    reads."""
    from repro_torch.ckpt import CheckpointManager, restore_train_state
    from repro_torch.data.lm_data import LMBatcher
    from repro_torch.launch import make_train_step
    from repro_torch.launch.train import build_argparser, config_from_args
    from repro_torch.launch.train import main
    from repro_torch.optim import cosine_schedule
    ck = str(tmp_path / "ck")
    flags = ["--batch", "4", "--seq", "32", "--log-every", "1",
             "--ckpt-dir", ck, "--ckpt-every", "4"]
    main(["--host-devices", "2", "--steps", "4"] + flags)
    resumed = {}
    main(["--host-devices", "4", "--model-parallel", "2", "--steps", "5",
          "--restore"] + flags, stats=resumed)
    out = capfd.readouterr().out
    assert "restored step 4" in out
    assert "mesh={'data': 2, 'model': 2}" in out
    assert resumed["step"] == [5]
    args = build_argparser().parse_args(flags + ["--steps", "5"])
    cfg = config_from_args(args)
    state, _ = restore_train_state(CheckpointManager(ck), cfg, "cpu",
                                   step=4)
    data = LMBatcher(cfg.vocab, 4, 32, seed=0)
    it = iter(data)
    for _ in range(4):
        next(it)
    batch = {k: torch.as_tensor(v) for k, v in next(it).items()}
    data.close()
    lr = cosine_schedule(args.lr, warmup=20, total=100)
    _, metrics = make_train_step(cfg, lr)(state, batch)
    assert abs(resumed["loss"][0] - float(metrics["loss"])) <= \
        1e-5 * float(metrics["loss"])
    assert abs(resumed["grad_norm"][0] - float(metrics["grad_norm"])) <= \
        1e-3 * float(metrics["grad_norm"])
