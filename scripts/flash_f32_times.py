#!/usr/bin/env python3
"""Device time of the f32 flash-attention kernel at three model shapes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/flash_f32_times.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one run on
one card: ``--src parent/src``, then the default, in turns.  For each
case (``CASES``: yi-9b causal, gemma3-12b's local layers, whisper-large-v3
cross-attention, all f32 at full head width, batch 1) it prints one JSON
line: the device time per call of ``flash_fwd`` from ``torch.profiler``
(``chip_smoke.device_ms``), the CUDA-event time, the bound
(``chip_smoke.bound_ms``: 4 H hd flops per unmasked pair at the f32 peak,
against the bytes of q, k, v and o), and the output's max |err| against
the plain version (``atol`` 1e-5).  Inputs are seeded ``torch.randn`` on
the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (S, T, H, KV, hd, causal, window), as in chip_smoke.ATTENTION
CASES = {
    "d_yi_9b_causal_f32": (4096, 4096, 32, 4, 128, True, 0),
    "e_gemma3_12b_local_f32": (4096, 4096, 16, 8, 240, True, 1024),
    "f_whisper_cross_f32": (448, 1500, 20, 20, 64, False, 0),
}
ATOL = 1e-5
REPS, WARMUP = 20, 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import bound_ms, device_ms, live_pairs, time_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    ok = True
    for name, (S, T, H, KV, hd, causal, window) in CASES.items():
        q = torch.randn(1, S, H, hd, device=dev, generator=gen)
        k = torch.randn(1, T, KV, hd, device=dev, generator=gen)
        v = torch.randn(1, T, KV, hd, device=dev, generator=gen)

        def call():
            return fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
        err = float((call() - flash_attention_ref(
            q, k, v, causal=causal, window=window)).abs().max())
        nbytes = 2 * q.numel() * 4 + 2 * k.numel() * 4
        flops = 4 * H * hd * live_pairs(S, T, causal, window)
        b_ms, b_by = bound_ms(nbytes, flops)
        dev_ms = device_ms(call, torch, REPS, "flash_fwd",
                           launches_per_call=1)
        print(json.dumps({
            "label": args.label, "case": name,
            "shape": [1, S, T, H, KV, hd], "causal": causal,
            "window": window, "device_ms": dev_ms,
            "event_ms": time_cuda(call, torch, REPS, WARMUP),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / dev_ms, "flops": flops, "bytes": nbytes,
            "max_abs_err": err, "atol": ATOL, "ok": err <= ATOL,
            "card": card}), flush=True)
        ok = ok and err <= ATOL
        del q, k, v
    if not ok:
        print(f"flash_f32_times: {args.label}: the kernel disagrees with its "
              f"plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
