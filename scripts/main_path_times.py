#!/usr/bin/env python3
"""Windows/sec of the fleet main path for one tree, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/main_path_times.py [--src DIR] [--label NAME] [--T 100]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one call on
one card, in turns (parent, change, change, parent).  The path is
``chip_smoke.py``'s main path: the ``fleet_scan`` golden's planner and
controller at E = 1024 sites (4 regions x 256), k = 8, N = 256, a pool of
4 generated windows cycled to T windows, both kernels on, on-device
answers.  It prints one JSON line: windows/sec of two timed runs after a
warm-up, the WAN bytes, and the kernel launches and host ms of each step
stage per window from ``torch.profiler`` over 3 windows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--T", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("main_path_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import MAIN, main_scenario
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.data.streams import fleet_like

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    E = MAIN["n_regions"] * MAIN["sites_per_region"]
    k, N, P = MAIN["k"], MAIN["window"], MAIN["pool"]
    vals, _ = fleet_like(n_sites=E, n_regions=MAIN["n_regions"], k=k,
                         n_points=P * N, seed=15)
    windows = [np.ascontiguousarray(vals[:, :, i * N:(i + 1) * N])
               for i in range(P)]
    sc = ScenarioConfig.from_dict(main_scenario(
        k, N, MAIN["n_regions"], MAIN["sites_per_region"], P * N))
    ex = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                  device="cuda")
    ex.run(windows, n_windows=2)                  # warm-up: build, allocator
    wps, wan = [], None
    for _ in range(2):
        rep = ex.run(windows, n_windows=args.T)
        wps.append(rep.raw["windows_per_sec"])
        wan = rep.wan_bytes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ex.run(windows, n_windows=3)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    on_dev = [e for e in evs if str(e.device_type).endswith("CUDA")
              and not e.key.startswith(("window_step/", "Memcpy"))]
    stages = {e.key.split("/", 1)[1]: e.cpu_time_total / 1e3 / 3
              for e in evs if e.key.startswith("window_step/")
              and not str(e.device_type).endswith("CUDA")}
    print(json.dumps({"label": args.label, "card": card, "T": args.T,
                      "windows_per_sec": wps, "wan_bytes": wan,
                      "launches_per_window": sum(e.count for e in on_dev) / 3,
                      "stage_host_ms_per_window": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
