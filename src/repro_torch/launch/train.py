"""End-to-end training driver (port of ``repro.launch.train``, the entry
point behind ``examples/train_lm.py``).

    python -m repro_torch.launch.train [--arch starcoder2-3b] [--full] ...

Trains any architecture of the zoo (smoke or full config) on the
synthetic Markov token stream, on one device: the GPU by default
(``--device cpu`` for the CPU).  With no arguments it runs the example's
default: starcoder2 smoke, 150 steps of 8 x 64 tokens at lr 8e-3.

  * checkpoints: ``--ckpt-dir`` with a save every ``--ckpt-every`` steps
    and at the end, in the reference's format and stacked layout (the
    reference's ``repro.ckpt.restore`` reads them, and the port reads the
    reference's); ``--restore`` resumes from the newest one.  A resumed
    run first draws the batches of the steps it skips, so it trains on
    the batches an uninterrupted run would (the reference's restart
    starts the stream over);
  * fault injection: ``--fail-at-step N`` raises before step N;
    rerunning with ``--restore`` continues from the last checkpoint;
  * ``--d-model`` and ``--n-layers`` override the config's width and
    depth, as in the reference;
  * the modality stubs (whisper's frames, qwen2-vl's patches) are fed
    zeros, as the reference's driver feeds them (:func:`stub_extras`);
    at those families' full depth the zero rows' gradients overflow to
    NaN in both packages (ROADMAP queue 3, note o).

The mesh flags (``--host-devices``, ``--pods``, ``--model-parallel``) and
the paper's gradient exchange (``--edge-exchange``) need LM sharding
(ROADMAP queue 1, item 4f) and raise ``NotImplementedError``.

An MoE model's aux losses (``moe_lb``, ``moe_z``) are logged beside the
loss.  Each step's two halves, the loss with its gradients and the optimizer,
are timed apart (with a device synchronize between them on the GPU); the
run ends with a summary line of the median step, tokens/sec and the peak
device memory, which ``main(argv, stats=d)`` also writes into ``d``.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Optional

# examples/train_lm.py's default run
DEFAULT_ARGV = ["--arch", "starcoder2-3b", "--steps", "150", "--batch", "8",
                "--seq", "64", "--lr", "8e-3", "--log-every", "25"]


def build_argparser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--edge-exchange", action="store_true")
    ap.add_argument("--dcn-budget", type=float, default=0.5)
    ap.add_argument("--exchange-window", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. build a ~100M variant)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, raising without "
                         "one; 'cpu' for the CPU)")
    return ap


def _refuse_sharding(args) -> None:
    for flag, on in (("--host-devices", args.host_devices != 0),
                     ("--pods > 1", args.pods > 1),
                     ("--model-parallel > 1", args.model_parallel > 1),
                     ("--edge-exchange", args.edge_exchange)):
        if on:
            raise NotImplementedError(
                f"{flag} needs LM sharding, not ported yet (ROADMAP queue 1, "
                f"item 4f); the port trains on one device")


def config_from_args(args):
    """The architecture's config with the width and depth overrides."""
    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  head_dim=args.d_model // cfg.n_heads,
                                  d_ff=4 * args.d_model if cfg.d_ff else 0)
    if args.n_layers:
        period = cfg.period
        n = max(period, (args.n_layers // period) * period)
        cfg = dataclasses.replace(cfg, n_layers=n)
    return cfg


def stub_extras(cfg) -> dict:
    """The modality stubs' inputs the driver feeds, as the reference's
    does: zero arrays (``LMBatcher``'s ``extras``) of the patch
    embeddings (n_patches, d) or the encoder's frame embeddings
    (encoder.seq_len, d), f32, per row."""
    import numpy as np
    extras = {}
    if cfg.frontend == "vision_stub":
        extras["patch_embeds"] = ((cfg.n_patches, cfg.d_model), np.float32)
    if cfg.frontend == "audio_stub":
        extras["encoder_embeds"] = ((cfg.encoder.seq_len, cfg.d_model),
                                    np.float32)
    return extras


def random_stub_inputs(cfg, rows: int, rng) -> dict:
    """Seeded normal stub inputs for ``rows`` rows, numpy f32 of
    :func:`stub_extras`' shapes: the frames or patches that parity checks
    feed, where the driver's zeros would leave whisper's encoder silent
    (a text-only family gets none, and ``rng`` is not drawn from)."""
    return {k: rng.normal(0, 1, (rows, *shape)).astype(dtype)
            for k, (shape, dtype) in stub_extras(cfg).items()}


def main(argv=None, stats: Optional[dict] = None):
    """Train as ``argv`` says (None: ``sys.argv[1:]``; empty: the
    example's default) and return the logged losses.  ``stats``, when
    given, receives every step's loss, grad norm and times and the run's
    summary."""
    if argv is None:
        argv = sys.argv[1:]
    args = build_argparser().parse_args(list(argv) or DEFAULT_ARGV)
    _refuse_sharding(args)

    import torch

    from repro_torch import resolve_device
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.lm_data import LMBatcher
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import (init_params, train_state_from_jax,
                                    train_state_template, train_state_to_jax)
    from repro_torch.models.transformer import MOE_AUX
    from repro_torch.optim.adamw import adamw_init, cosine_schedule, tree_map

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    print(f"[train] arch={cfg.name} device={device} "
          f"params~{cfg.param_count():,}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lr = cosine_schedule(args.lr, warmup=20, total=max(args.steps, 100))

    # ---- state init / restore -------------------------------------------
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start_step = 0
    state = None
    if args.restore and ckpt is not None:
        saved, step = ckpt.restore(train_state_template(cfg), device="cpu")
        if saved is not None:
            host = train_state_from_jax(saved, cfg)
            state = dataclasses.replace(
                host, **{f: tree_map(lambda t: t.to(device), getattr(host, f))
                         for f in ("params", "m", "v")})
            start_step = step
            print(f"[train] restored step {step} from {args.ckpt_dir}",
                  flush=True)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = adamw_init(init_params(cfg, gen, device=device))

    train_step = make_train_step(cfg, lr, microbatches=args.microbatches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    data = LMBatcher(cfg.vocab, args.batch, args.seq, seed=args.seed,
                     extras=stub_extras(cfg))
    record = {"step": [], "loss": [], "grad_norm": [], "fwd_bwd_ms": [],
              "opt_ms": []}
    losses = []
    t0 = time.time()
    try:
        it = iter(data)
        for _ in range(start_step):     # the batches the resumed steps drew
            next(it)
        for step in range(start_step, args.steps):
            if step == args.fail_at_step:
                print(f"[train] INJECTED FAILURE at step {step}", flush=True)
                raise RuntimeError("injected node failure")
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(it).items()}
            sync()
            t_a = time.perf_counter()
            loss, metrics, grads = train_step.loss_and_grads(state, batch)
            sync()
            t_b = time.perf_counter()
            state, metrics = train_step.apply(state, grads, loss, metrics)
            del grads
            sync()
            t_c = time.perf_counter()
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            aux = {k: float(metrics[k]) for k in MOE_AUX if k in metrics}
            for k, val in (("step", step + 1), ("loss", loss),
                           ("grad_norm", gnorm),
                           ("fwd_bwd_ms", 1e3 * (t_b - t_a)),
                           ("opt_ms", 1e3 * (t_c - t_b)), *aux.items()):
                record.setdefault(k, []).append(val)
            if (step + 1) % args.log_every == 0 or step == start_step:
                losses.append(loss)
                print(f"[train] step={step + 1} loss={loss:.4f} "
                      f"gnorm={gnorm:.3f} " + "".join(
                          f"{k}={v:.4f} " for k, v in aux.items())
                      + f"({time.time() - t0:.1f}s)", flush=True)
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(train_state_to_jax(state, cfg), step + 1)
        if ckpt is not None:
            ckpt.save(train_state_to_jax(state, cfg), args.steps)
            ckpt.wait()
    finally:
        data.close()

    summary = {}
    if record["step"]:
        fb = statistics.median(record["fwd_bwd_ms"])
        op = statistics.median(record["opt_ms"])
        step_ms = statistics.median(
            [a + b for a, b in zip(record["fwd_bwd_ms"], record["opt_ms"])])
        summary = {"median_step_ms": step_ms, "median_fwd_bwd_ms": fb,
                   "median_opt_ms": op,
                   "tokens_per_sec": args.batch * args.seq / (step_ms / 1e3),
                   "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else None)}
        peak = summary["peak_mem_bytes"]
        print(f"[train] median step {step_ms:.1f} ms (forward+backward "
              f"{fb:.1f}, optimizer {op:.1f}), "
              f"{summary['tokens_per_sec']:.0f} tokens/s, peak memory "
              f"{'not measured (cpu)' if peak is None else f'{peak:,} B'}",
              flush=True)
    if stats is not None:
        stats.update(record, **summary, arch=cfg.name, device=str(device),
                     params=cfg.param_count(),
                     tokens_per_step=args.batch * args.seq)
    print(f"[train] done. first logged loss={losses[0]:.4f} "
          f"last={losses[-1]:.4f}" if losses else "[train] done.",
          flush=True)
    return losses


if __name__ == "__main__":
    main()
