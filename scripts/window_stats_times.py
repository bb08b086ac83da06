#!/usr/bin/env python3
"""Device time of the one-window statistics kernel at five window shapes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/window_stats_times.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one run on
one card: ``--src parent/src``, then the default, in turns.  For each
(k, N, dtype) of ``SHAPES`` (``chip_smoke.WINDOWS``: the shapes of
``benchmarks/kernel_bench.py`` and one window larger than L2) it prints
one JSON line: the device time per call of the tree's ``stream_stats``
kernels from ``torch.profiler`` (``chip_smoke.device_ms``, with the
kernels a call launches counted from the tree's source), the CUDA-event
time of a call (which includes the wrapper's host work), the host time
of a call (``EVENT_REPS`` calls queued back to back on the host clock),
the bound
(``chip_smoke.bound_ms``: x's bytes and the outputs' against k(k+1)N +
7kN flops at the input type's peak) and the share of it the kernel
reaches, the launch floor (``chip_smoke.launch_floor_ms``: the device
time of a one-element ``add_``), the outputs' max |err| against the
plain version (``chip_smoke.WINDOW_TOL``), and the card's name and power
limit.  Inputs are seeded ``torch.randn`` on the card.  It needs
``chip_smoke.py`` beside ``scripts/`` and exits 1 without it, without a
card, or when a kernel disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS, EVENT_REPS = 20, 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    cu = os.path.join(src, "repro_torch/kernels/csrc/stream_stats.cu")
    if not (os.path.exists(os.path.join(HERE, "chip_smoke.py"))
            and os.path.exists(cu)):
        print(f"window_stats_times: needs chip_smoke.py in {HERE} and "
              f"{cu}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("window_stats_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS, WINDOW_TOL,
                            WINDOWS, bound_ms, device_ms, launch_floor_ms,
                            time_cuda)
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.kernels.stream_stats.ref import stream_stats_ref

    # every kernel of the tree's source runs once per call
    with open(cu) as f:
        per_call = len(re.findall(r"__global__", f.read()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    floor = launch_floor_ms(torch)
    ok = True
    for k, n, dt in WINDOWS:
        x = torch.randn(k, n, device=dev, generator=gen).to(getattr(torch, dt))

        def call():
            return ss_ops.stream_stats_cuda(x)
        got, want = call(), stream_stats_ref(x)
        rtol, atol = WINDOW_TOL[dt]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        good = all(torch.allclose(g, w, rtol=rtol, atol=atol)
                   for g, w in zip(got, want))
        nbytes = x.numel() * x.element_size() + (4 * k + k * k) * 4
        flops = k * (k + 1) * n + 7 * k * n
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS
                              if dt == "bfloat16" else PEAK_F32_FLOPS)
        dev_ms = device_ms(call, torch, REPS, "stream_stats_",
                           launches_per_call=per_call)
        # the wrapper's host time a call, launches queued without waiting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EVENT_REPS):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / EVENT_REPS
        torch.cuda.synchronize()
        print(json.dumps({
            "label": args.label, "shape": [k, n], "dtype": dt,
            "device_ms": dev_ms, "event_ms": time_cuda(call, torch,
                                                       EVENT_REPS),
            "host_ms": host_ms,
            "launches_per_call": per_call, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / dev_ms,
            "launch_floor_ms": floor, "bytes": nbytes, "flops": flops,
            "max_abs_err": err, "rtol": rtol, "atol": atol, "ok": good,
            "card": card}), flush=True)
        ok = ok and good
        del x, got, want
    if not ok:
        print(f"window_stats_times: {args.label}: the kernel disagrees with "
              f"its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
