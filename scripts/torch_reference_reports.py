#!/usr/bin/env python3
"""Write the port's reference reports: the live JAX reference's report of
every golden the port runs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_reference_reports.py

For each scenario of ``tests/goldens/scenarios/`` that ``repro_torch``
runs (``repro_torch.sweep.not_ported`` is None), scan and event alike,
this runs the reference's ``Experiment`` on the CPU, serializes
the report with the reference's ``repro.sweep.report.serialize_report``
and writes ``tests/torch_goldens/reports/<name>.json``; for the scenarios
of ``repro_torch.sweep.runner.KERNEL_PATH_REPORTS`` it also runs the
reference's kernel path (its Pallas kernels in interpret mode) and writes
``tests/torch_goldens/kernel_reports/<name>.json``.  Provenance (JAX
version, commit, date) goes into ``tests/torch_goldens/PROVENANCE.json``,
never into the reports, so a report changes only when a number does.

The port's sweep (``python -m repro_torch.sweep``) diffs against these
files and never writes them.  This script imports the JAX package, so it
lives outside the port.

The reports are made with one JAX device (no ``XLA_FLAGS`` forcing
more), and the script refuses to run with more: on a mesh of several
devices the reference's sharded engine moves
``fleet_event_sharded_static``'s floats (4.7e-7 relative at four forced
host devices), while the port's sharded runs are bitwise its unsharded
ones at any world size.

The reference's IPM solver (every ``single_event_*`` golden) calls
``jax.experimental.enable_x64``, which JAX 0.9 no longer has; each
reference run is made with that name pointed at ``jax.enable_x64`` and
the name removed again afterwards (:func:`x64_workaround`).  Nothing in
the reference is edited.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "tests" / "torch_goldens"


def ported_goldens() -> list:
    """The goldens the port runs, as port ``SweepScenario``s."""
    from repro_torch.sweep import load_scenarios, not_ported
    return [s for s in load_scenarios() if not_ported(s) is None]


@contextlib.contextmanager
def x64_workaround():
    """``jax.experimental.enable_x64`` for the reference's IPM, where the
    installed JAX lacks it, for the body of the ``with`` only."""
    import jax
    import jax.experimental
    missing = not hasattr(jax.experimental, "enable_x64")
    if missing:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield
    finally:
        if missing:
            del jax.experimental.enable_x64


def reference_report(name: str, kernels: bool = False) -> dict:
    """The live reference's serialized report of golden ``name``; with
    ``kernels``, of its kernel path (Pallas in interpret mode)."""
    from repro.api.experiment import Experiment
    from repro.sweep.report import serialize_report
    from repro.sweep.runner import SCENARIO_DIR, load_scenario_file
    s = load_scenario_file(SCENARIO_DIR / f"{name}.json")
    opts = {"use_kernel": True, "interpret": True} if kernels else {}
    with x64_workaround():
        report = Experiment.from_scenario(s.config, **opts).run()
    return serialize_report(report, name=s.name, tolerance=s.tolerance)


def write_json(payload: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


def generate(out_dir: Path = OUT_DIR, names=None, log=print) -> dict:
    """Write ``<out_dir>/reports/<name>.json`` for ``names`` (default:
    every ported golden), ``<out_dir>/kernel_reports/<name>.json``
    for those of them the sweep holds to the reference's kernel path, and
    ``<out_dir>/PROVENANCE.json``; returns {name: report}."""
    import jax
    if jax.device_count() != 1:
        raise RuntimeError(
            f"the reference reports are made with one JAX device, not "
            f"{jax.device_count()}: unset XLA_FLAGS' forced device count")
    if names is None:
        names = [s.name for s in ported_goldens()]
    from repro_torch.sweep.runner import KERNEL_PATH_REPORTS
    reports = {}
    kernel_names = []
    for name in names:
        reports[name] = reference_report(name)
        write_json(reports[name], Path(out_dir) / "reports" / f"{name}.json")
        log(f"  {name:<34} written")
        if name in KERNEL_PATH_REPORTS:
            write_json(reference_report(name, kernels=True),
                       Path(out_dir) / "kernel_reports" / f"{name}.json")
            kernel_names.append(name)
            log(f"  {name:<34} written (kernel path)")
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    write_json({"generator": "scripts/torch_reference_reports.py",
                "jax": jax.__version__, "jax_backend": jax.default_backend(),
                "jax_devices": jax.device_count(),
                "commit": commit,
                "date": datetime.date.today().isoformat(),
                "scenarios": sorted(reports),
                "kernel_path_scenarios": sorted(kernel_names)},
               Path(out_dir) / "PROVENANCE.json")
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=OUT_DIR)
    p.add_argument("names", nargs="*",
                   help="golden names (default: every ported golden)")
    args = p.parse_args(argv)
    generate(args.out, args.names or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
