"""``python -m repro_torch.sweep`` — did the port change any number?

    python -m repro_torch.sweep --check --filter scan --device cpu
    python -m repro_torch.sweep --list                 # scenarios, ported?
    python -m repro_torch.sweep --lint                 # load every file

``--device`` defaults to the GPU and raises without one.  ``--use-kernel``
``auto`` (the default) is ``Experiment``'s ``use_kernel=None``.

Exit codes: 0 clean, 1 drift (table printed), 2 usage (bad filter).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.sweep import runner

_USE_KERNEL = {"auto": None, "on": True, "off": False}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="Run the committed scenarios in the port and diff every "
                    "number against the port-owned reference reports.")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_const", dest="mode",
                      const="check",
                      help="run scenarios and diff vs reports (default)")
    mode.add_argument("--lint", action="store_const", dest="mode",
                      const="lint",
                      help="load every scenario file and exit")
    mode.add_argument("--list", action="store_const", dest="mode",
                      const="list",
                      help="enumerate scenarios and what the port runs")
    p.set_defaults(mode="check")
    p.add_argument("--filter", metavar="PAT", default=None,
                   help="only scenarios whose name contains PAT or whose "
                        "tags include PAT (e.g. 'smoke', 'fleet', 'scan')")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="where the port runs (default: the GPU)")
    p.add_argument("--use-kernel", choices=tuple(_USE_KERNEL),
                   default="auto",
                   help="the CUDA kernels: auto (on a CUDA device), on, off")
    p.add_argument("--scenario-dir", type=Path, default=runner.SCENARIO_DIR,
                   help=argparse.SUPPRESS)
    p.add_argument("--report-dir", type=Path, default=runner.REPORT_DIR,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return runner.run_sweep(
        mode=args.mode, pattern=args.filter,
        scenario_dir=args.scenario_dir, report_dir=args.report_dir,
        device=args.device, use_kernel=_USE_KERNEL[args.use_kernel])


if __name__ == "__main__":
    sys.exit(main())
