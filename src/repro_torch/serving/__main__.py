"""Serve a batch of requests: continuous batching + straggler eviction.

The port's counterpart of ``examples/serve_lm.py``: the same six prompts,
12 new tokens each, on four slots; the weights drawn from a seeded
generator on the device.

    PYTHONPATH=src python -m repro_torch.serving --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.serving            # gemma3-12b, GPU
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.serving import Request, ServeEngine

PROMPTS = [[7, 8, 9], [3, 1], [5, 5, 5, 5], [2], [11, 12], [4, 4, 9]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the GPU)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="prefill attention on the plain route")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    engine = ServeEngine(None, cfg, batch_slots=4, max_seq=96,
                         device=args.device, use_kernel=not args.no_kernel)
    for i, p in enumerate(PROMPTS):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=12))

    t0 = time.time()
    done = engine.run()
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s on {engine.model.device.type}, "
          f"batch={engine.B})")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req{r.rid} prompt={r.prompt} -> {r.generated}")


if __name__ == "__main__":
    main()
