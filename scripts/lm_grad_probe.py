"""Where a smoke LM train step's f32 gradients on the GPU leave the CPU's.

For each architecture's smoke config in f32 this takes one loss and its
gradients (``forward_train``, no recomputation) on the same seeded
parameters and batch as ``tests/test_torch_cuda.py``'s train-step tests,
on every device asked for, twice: in f32 as the port runs it, and with
every f32 point of the model widened to f64 (the models' and config's
``torch.float32`` read as ``torch.float64`` for the run; the parameters,
the batch and every op stay the same).  It records each layer's
attention and MLP (or MoE) output, the embedding and the logits, the
gradient of the loss at each of them, and every parameter's gradient,
and prints, for each recorded tensor in forward order and for each
parameter leaf, its largest difference over its largest magnitude:

* ``dev32``: the GPU's f32 against the CPU's f32;
* ``cpu32``, ``dev32_vs_64``: each f32 run against the f64 run on the
  same device (how far f32 order alone moves that tensor);
* ``dev64``: the GPU's f64 against the CPU's f64 (the same function on
  both devices up to f64 order when this is ~1e-12).

``attn_in<i>`` and ``mlp_in<i>`` are a layer's normed inputs to its
attention and MLP: the gradient's growth from ``attn<i>`` to
``attn_in<i>`` is that attention's own backward.  ``--replay`` runs each
layer's attention alone, on the f64 run's input and upstream gradient
rounded to f32, on each device in f32 and on the CPU in f64, and prints
each op's output (einsum, softmax, where, rsqrt, stack) and gradient
error against f64 per device: which op's f32 rounding differs between
the devices, with no upstream difference in the way.

    PYTHONPATH=src python scripts/lm_grad_probe.py --devices cpu
    PYTHONPATH=src python scripts/lm_grad_probe.py            # cpu and cuda

The full table goes to ``chiprun_out/lm_grad_probe.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import config as C  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402

ARCHS = ["gemma3-12b", "starcoder2-3b", "yi-9b", "chatglm3-6b",
         "deepseek-moe-16b", "qwen3-moe-30b-a3b"]
BATCH = (2, 24)


class _Wide:
    """``torch`` with ``float32`` read as ``float64``."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


# the LM stack's modules whose ``torch.float32`` an f64 run reads as f64
# (the sharded step's too: ``tests/test_torch_lm_mesh_ranks.py`` and
# ``chip_smoke.py``'s mesh phase widen their runs with :func:`widened`)
WIDE_MODULES = ("models.config", "models.layers", "models.transformer",
                "launch.steps", "optim.adamw", "optim.edge_exchange",
                "parallel.sharding", "parallel.collectives")


@contextlib.contextmanager
def widened(on: bool):
    """Every f32 of the port's LM stack read as f64 inside (the modules'
    ``torch`` swapped) when ``on``."""
    import importlib
    mods = [importlib.import_module(f"repro_torch.{n}") for n in WIDE_MODULES]
    if not on:
        yield
        return
    for m in mods:
        m.torch = _Wide()
    try:
        yield
    finally:
        for m in mods:
            m.torch = torch


def batch_for(vocab: int) -> dict:
    """``tests/test_torch_cuda.py::_train_batch``."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, BATCH).astype(np.int32)
    labels = rng.integers(0, vocab, BATCH).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


@contextlib.contextmanager
def recorded(acts: dict, grads: dict):
    """Record the named forward tensors and the loss's gradient at each."""
    saved = {n: getattr(L, n) for n in ("attention_apply", "mlp_apply",
                                        "moe_apply") if hasattr(L, n)}
    saved_t = {n: getattr(T, n) for n in ("_embed_tokens", "_lm_logits")}
    count = {}

    def keep(name, t):
        i = count.get(name, 0)
        count[name] = i + 1
        key = f"{name}{i}"
        acts[key] = t.detach().double().cpu()
        if t.requires_grad:
            t.register_hook(lambda g: grads.__setitem__(
                key, g.detach().double().cpu()))

    def wrap(name, fn, first, arg=None):
        def spy(*a, **kw):
            if arg is not None:             # the op's input, as it reads it
                keep(name + "_in", a[arg])
            out = fn(*a, **kw)
            keep(name, out[0] if first else out)
            return out
        return spy
    L.attention_apply = wrap("attn", saved["attention_apply"], True, 1)
    L.mlp_apply = wrap("mlp", saved["mlp_apply"], False, 1)
    if "moe_apply" in saved:
        L.moe_apply = wrap("moe", saved["moe_apply"], True, 1)
    T._embed_tokens = wrap("embed", saved_t["_embed_tokens"], False)
    T._lm_logits = wrap("logits", saved_t["_lm_logits"], False)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(L, n, f)
        for n, f in saved_t.items():
            setattr(T, n, f)


def one_run(cfg, device: str, wide: bool) -> dict:
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(7))
    dt = torch.float64 if wide else torch.float32
    params = tree_map(lambda t: t.to(device, dt).requires_grad_(True), params)
    batch = batch_for(cfg.vocab)
    acts, act_grads = {}, {}
    with widened(wide), recorded(acts, act_grads):
        loss, metrics = T.forward_train(params, batch, cfg, remat=False)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(loss.detach()), "acts": acts, "act_grads": act_grads,
            "grads": [g.detach().double().cpu() for g in grads],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else 0.0


def leaf_names(cfg) -> list:
    from repro_torch.models import init_params
    tree = init_params(cfg, None, device="meta")

    def names(t, prefix):
        if isinstance(t, dict):
            return [n for k in sorted(t)
                    for n in names(t[k], f"{prefix}/{k}")]
        if isinstance(t, (list, tuple)):
            return [n for i, x in enumerate(t)
                    for n in names(x, f"{prefix}/{i}")]
        return [prefix]
    return names(tree, "")


def compare(runs: dict, cfg) -> dict:
    devs = [d for d in runs if d != "cpu"]
    out = {"loss": {k: v["loss"] for k, v in
                    ((f"{d}/{w}", runs[d][w]) for d in runs for w in runs[d])}}
    c32, c64 = runs["cpu"]["f32"], runs["cpu"]["f64"]

    def table(field, keys):
        rows = []
        for i, key in enumerate(keys):
            def get(r):
                v = r[field]
                return v[i] if isinstance(v, list) else v.get(key)
            row = {"name": key, "cpu32": rel(get(c32), get(c64))}
            for d in devs:
                g32, g64 = get(runs[d]["f32"]), get(runs[d]["f64"])
                row.update({"dev32": rel(g32, get(c32)),
                            "dev32_vs_64": rel(g32, g64),
                            "dev64": rel(g64, get(c64))})
            rows.append(row)
        return rows
    out["acts"] = table("acts", list(c32["acts"]))
    out["act_grads"] = table("act_grads", [k for k in c32["acts"]
                                           if k in c32["act_grads"]])
    out["grads"] = table("grads", leaf_names(cfg))
    return out


class _Recorder:
    """``base`` (``torch`` or :class:`_Wide`) whose ops in ``OPS`` hand
    their outputs to ``keep(name, tensor)``."""
    OPS = ("einsum", "softmax", "where", "rsqrt", "stack", "tanh")

    def __init__(self, base, keep):
        self._base, self._keep = base, keep

    def __getattr__(self, name):
        fn = getattr(self._base, name)
        if name not in self.OPS:
            return fn

        def rec(*a, **kw):
            out = fn(*a, **kw)
            self._keep(name, out)
            return out
        return rec


def replay_layer(cfg, params: dict, layer: int, x64, g64, device: str,
                 wide: bool) -> dict:
    """Layer ``layer``'s attention alone on the f64 run's input rounded to
    f32 (``x64``), its backward from the f64 run's gradient rounded to f32
    (``g64``): in f32 on ``device``, or in f64 (``wide``).  Returns every
    recorded op's output and gradient, the input's and the weights'
    gradients."""
    dt = torch.float64 if wide else torch.float32
    mixer = {n: t.detach().to(device, dt).requires_grad_(True)
             for n, t in params["layers"][layer]["mixer"].items()}
    x = x64.to(torch.float32).to(device, dt).requires_grad_(True)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=device)[None, :].expand(b, s)
    acts, grads, count = {}, {}, {}

    def keep(name, t):
        i = count.get(name, 0)
        count[name] = i + 1
        key = f"{name}{i}"
        acts[key] = t.detach().double().cpu()
        if t.requires_grad:
            t.register_hook(lambda g: grads.__setitem__(
                key, g.detach().double().cpu()))
    base = _Wide() if wide else torch
    saved = (C.torch, L.torch, T.torch)
    C.torch = L.torch = T.torch = _Recorder(base, keep)
    try:
        out, _ = L.attention_apply(mixer, x, positions, cfg,
                                   window=T._window(cfg, layer % cfg.period))
        out.backward(g64.to(torch.float32).to(device, dt))
    finally:
        C.torch, L.torch, T.torch = saved
    grads.update({"x": x.grad.double().cpu(),
                  **{f"d{n}": t.grad.double().cpu()
                     for n, t in mixer.items()}})
    acts["out"] = out.detach().double().cpu()
    return {"acts": acts, "grads": grads}


def replay(cfg, devices: list) -> list:
    """Every layer's attention replayed alone (:func:`replay_layer`) on
    each device and in f64: each op's forward error and gradient error
    against f64, per device."""
    from repro_torch.models import init_params
    exact = one_run(cfg, "cpu", True)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    rows = []
    for i in range(cfg.n_layers):
        x64, g64 = exact["acts"][f"attn_in{i}"], exact["act_grads"][f"attn{i}"]
        want = replay_layer(cfg, params, i, x64, g64, "cpu", True)
        got = {d: replay_layer(cfg, params, i, x64, g64, d, False)
               for d in devices}
        for part in ("acts", "grads"):
            for key in want[part]:
                row = {"layer": i, "part": part, "op": key}
                for d in devices:
                    row[d] = rel(got[d][part][key], want[part][key])
                rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=ARCHS)
    ap.add_argument("--devices", nargs="+", default=["cpu", "cuda"])
    ap.add_argument("--out", default=os.path.join(HERE, "..", "chiprun_out",
                                                  "lm_grad_probe.json"))
    ap.add_argument("--replay", action="store_true",
                    help="replay each layer's attention alone on the f64 "
                         "run's inputs instead")
    args = ap.parse_args(argv)
    if "cpu" not in args.devices:
        args.devices.insert(0, "cpu")
    report = {}
    if args.replay:
        for arch in args.archs:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            report[arch] = replay(cfg, args.devices)
            for r in report[arch]:
                print(f"  {arch} layer {r['layer']} {r['part']:5s} "
                      f"{r['op']:10s} " + " ".join(
                          f"{d}={r[d]:.3e}" for d in args.devices))
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        return 0
    for arch in args.archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        runs = {d: {w: one_run(cfg, d, w == "f64") for w in ("f32", "f64")}
                for d in args.devices}
        rep = compare(runs, cfg)
        report[arch] = rep
        worst = {}
        for part in ("acts", "act_grads", "grads"):
            for col in rep[part][0]:
                if col != "name":
                    worst[f"{part}:{col}"] = max(r[col] for r in rep[part])
        print(json.dumps({"arch": arch, "loss": rep["loss"],
                          "worst": worst}), flush=True)
        for part in ("acts", "act_grads", "grads"):
            for r in rep[part]:
                print(f"  {part:9s} {r['name']:32s} " + " ".join(
                    f"{k}={v:.3e}" for k, v in r.items() if k != "name"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
