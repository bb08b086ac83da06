#!/usr/bin/env python3
"""Windows/sec of the sharded scan at the main path's width, on 1 and W
ranks, each run held bitwise to the world-size-1 run.

Run from the root of a checkout, on a machine with NVIDIA GPUs:

    python3 scripts/sharded_times.py [--world 2 4] [--T 20] [--src DIR]

The path is ``chip_smoke.py``'s ``sharded_path``: the ``fleet_scan``
golden's planner and controller on ``runtime="scan_sharded"`` at E = 1024
sites (4 regions x 256), k = 8, N = 256, a pool of 4 generated windows
cycled to T windows, both kernels on, on-device answers.  It first runs
the path in this process (world size 1, after a warm-up), then, for each
``--world`` W, spawns W ranks on a gloo group, rank r on card
r % (the cards present), each over its 1024 / W sites.  Every rank's
report (every per-window table, NRMSE and the final state) is compared
bit for bit with the world-size-1 run.  One JSON line per world size:
each rank's windows/sec (its own loop, the final gather excluded), its
launches of rows 1 and 2, whether it was bitwise, and the cards' names
and power limits.  The ranks' run fails past ``--timeout`` seconds.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paths(src: str) -> None:
    for p in (HERE, os.path.abspath(src)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _rank(rank: int, world: int, tmp: str, src: str, scenario: dict,
          T: int, timeout_s: float) -> None:
    """One spawned rank: its card, the gloo group, a warm-up and the
    timed run; its report arrays to ``rank<r>.npz``, its pace and
    launches to ``rank<r>.json``."""
    _paths(src)
    import numpy as np
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        windows = list(np.load(os.path.join(tmp, "windows.npy")))
        cs._sharded_experiment(scenario).run(windows, n_windows=2)
        ex = cs._sharded_experiment(scenario)
        cs._zero_row_launches()
        rep = ex.run(windows, n_windows=T)
        torch.cuda.synchronize()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **cs._run_arrays(rep))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "card": torch.cuda.current_device(),
                       "rows": ex.runtime.shard.rows,
                       "windows_per_sec": rep.raw["windows_per_sec"],
                       "launches": cs._row_launches()}, f)
    finally:
        dist.destroy_process_group()


def _ranks(world: int, windows, src: str, scenario: dict, T: int,
           timeout_s: float, want: dict) -> list:
    import numpy as np
    import torch.multiprocessing as mp
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "windows.npy"), np.stack(windows))
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            _rank, args=(world, tmp, src, scenario, T, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > timeout_s:
                    raise RuntimeError(f"{world} ranks did not finish in "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info = json.load(f)
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as data:
                same = cs._same_arrays(dict(data), want)
            info["bitwise"] = all(same.values())
            out.append(info)
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--world", type=int, nargs="+", default=[2])
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    _paths(args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.data.streams import fleet_like
    from repro_torch.kernels import build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip().splitlines()
    build.build_all(["stream_stats_fleet", "polyfit_moments"])
    M = cs.MAIN
    E, k, N, P = (M["n_regions"] * M["sites_per_region"], M["k"],
                  M["window"], M["pool"])
    vals, _ = fleet_like(n_sites=E, n_regions=M["n_regions"], k=k,
                         n_points=P * N, seed=15)
    windows = [np.ascontiguousarray(vals[:, :, i * N:(i + 1) * N])
               for i in range(P)]
    scenario = dict(cs.main_scenario(k, N, M["n_regions"],
                                     M["sites_per_region"], P * N),
                    runtime="scan_sharded")
    cs._sharded_experiment(scenario).run(windows, n_windows=2)   # warm-up
    cs._zero_row_launches()
    rep = cs._sharded_experiment(scenario).run(windows, n_windows=args.T)
    torch.cuda.synchronize()
    want = cs._run_arrays(rep)
    print(json.dumps({"world": 1, "E": E, "k": k, "N": N, "T": args.T,
                      "cards": cards,
                      "windows_per_sec": rep.raw["windows_per_sec"],
                      "launches": cs._row_launches()}), flush=True)
    ok = True
    for world in args.world:
        per_rank = _ranks(world, windows, args.src, scenario, args.T,
                          args.timeout, want)
        ok &= all(r["bitwise"] and r["launches"] == {
            "stream_stats_fleet": 2 * args.T, "polyfit": args.T}
            for r in per_rank)
        print(json.dumps({"world": world, "E": E, "T": args.T,
                          "cards": cards,
                          "cards_used": sorted({r["card"]
                                                for r in per_rank}),
                          "windows_per_sec": min(r["windows_per_sec"]
                                                 for r in per_rank),
                          "per_rank": per_rank}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
