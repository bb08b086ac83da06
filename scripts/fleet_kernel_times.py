#!/usr/bin/env python3
"""Device time of the fleet path's two CUDA kernels at two shapes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/fleet_kernel_times.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one run on
one card: ``--src parent/src``, then the default, in turns.  For
``stream_stats_fleet`` at x (E, k, N) and ``polyfit`` at y, u (E k, N)
it prints one JSON line per (kernel, shape): the device time per call
from ``torch.profiler`` (``chip_smoke.device_ms``), the CUDA-event time,
and the bytes bound.  The shapes are the main path's (E 1024, k 8,
N 256) and a larger fleet whose data does not fit in L2 (E 4096, k 8,
N 1024).  Inputs are seeded ``torch.randn`` on the card; each output is
held against its plain version (power sums bitwise).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {"main": (1024, 8, 256), "large": (4096, 8, 1024)}
# profiled and event-timed calls per kernel and shape, as in chip_smoke.py
REPS = 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("fleet_kernel_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import PEAK_BYTES_PER_S, device_ms, time_cuda
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.polyfit.ref import polyfit_ref
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.kernels.stream_stats.ref import fleet_stats_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    for shape_name, (e, k, n) in SHAPES.items():
        x = torch.randn(e, k, n, device=dev, generator=gen) * 1.5 + 2.0
        y = torch.randn(e * k, n, device=dev, generator=gen) * 2.0
        u = torch.randn(e * k, n, device=dev, generator=gen)
        mom, xxt = ss_ops.stream_stats_fleet_cuda(x)
        mom_r, xxt_r = fleet_stats_ref(x)
        pu, py = poly_ops.polyfit_cuda(y, u)
        pu_r, py_r = polyfit_ref(y, u)
        pu_r[:, 0] = float(n)
        ok = {"stream_stats_fleet": bool(
                  torch.equal(mom, mom_r)
                  and torch.allclose(xxt, xxt_r, rtol=2e-5, atol=1e-2)),
              "polyfit": bool(torch.equal(pu, pu_r)
                              and torch.equal(py, py_r))}
        del mom_r, xxt_r, pu_r, py_r
        cases = {
            "stream_stats_fleet": (lambda: ss_ops.stream_stats_fleet_cuda(x),
                                   "stream_stats_fleet_kernel",
                                   x.numel() * 4 + e * k * (4 + k) * 4),
            "polyfit": (lambda: poly_ops.polyfit_cuda(y, u), "polyfit_kernel",
                        2 * y.numel() * 4 + y.shape[0] * 11 * 4)}
        for kernel, (fn, match, nbytes) in cases.items():
            print(json.dumps({
                "label": args.label, "kernel": kernel, "shape_name": shape_name,
                "shape": [e, k, n] if kernel != "polyfit" else [e * k, n],
                "device_ms": device_ms(fn, torch, REPS, match,
                                       launches_per_call=1),
                "event_ms": time_cuda(fn, torch, REPS),
                "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bytes": nbytes,
                "ok": ok[kernel], "card": card}), flush=True)
        if not all(ok.values()):
            print(f"fleet_kernel_times: {args.label} {shape_name}: a kernel "
                  f"disagrees with its plain version: {ok}", file=sys.stderr)
            return 1
        del x, y, u
    return 0


if __name__ == "__main__":
    sys.exit(main())
