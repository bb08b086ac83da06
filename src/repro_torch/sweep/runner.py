"""The port's sweep runner: committed scenarios -> port reports -> diffs.

Port of ``repro.sweep.runner``, with four differences:

  * The scenarios are the reference's committed files,
    ``tests/goldens/scenarios/<name>.json``, read only and loaded through
    the port's :meth:`~repro_torch.api.scenario.ScenarioConfig.from_dict`.
  * The reports it diffs against are port-owned,
    ``tests/torch_goldens/reports/<name>.json``: the live reference's
    reports, serialized by the reference's own ``serialize_report``
    (``scripts/torch_reference_reports.py`` writes them).  The reference
    no longer reproduces its committed ``tests/goldens/reports/``, so
    those are never read here.
  * There is no perf gate: the committed ``BENCH_throughput.json``
    measured the JAX package, and the port has no benchmark yet.
  * There is no ``--update``: the port never writes its own oracle.

Every scenario is held to the tolerance class its file names, with two
recorded exceptions on the CUDA kernels' path (the fused fit).
``KERNEL_CLASS_GAPS`` lists the scenarios whose floats meet a looser
class there (the class they meet beside the golden's, and why); such a
scenario is held to the recorded class on that path only, and every
``--check`` line prints both classes.  ``KERNEL_PATH_REPORTS`` lists the
scenarios whose counters, or floats beyond the class the port is held to
on that path, differ between the reference's own two paths: where the fit
is the fused one (``use_kernel=True``) they are held, in that class, to
the live reference's kernel path (its Pallas kernels in interpret mode,
``tests/torch_goldens/kernel_reports/``).  Counters are always bitwise.
A scenario the port cannot run yet is listed by name with the ROADMAP
item that ports it ("not ported"); it is never counted as checked.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Optional

from repro_torch import resolve_device
from repro_torch.sweep.diff import (Drift, TOLERANCE_CLASSES, diff_reports,
                                    format_drift_table)
from repro_torch.sweep.report import serialize_report

REPO_ROOT = Path(__file__).resolve().parents[3]
SCENARIO_DIR = REPO_ROOT / "tests" / "goldens" / "scenarios"
REPORT_DIR = REPO_ROOT / "tests" / "torch_goldens" / "reports"
KERNEL_REPORT_DIR = REPO_ROOT / "tests" / "torch_goldens" / "kernel_reports"


@dataclasses.dataclass(frozen=True)
class ClassGap:
    """A scenario whose floats meet ``meets``, not its golden's ``golden``."""

    meets: str
    golden: str
    reason: str


_FUSED_FIT = ("with the kernels on, the cubic fit takes its normal "
              "equations from the polyfit kernel's fused Vandermonde moments"
              " (the reference's own kernel path), not from the per-product "
              "sums its CPU reports were made with; the two fits agree in "
              "f32, not to the last bit (ROADMAP.md queue 3, note e)")
# the kernels' path only (use_kernel True, or None on a CUDA device)
KERNEL_CLASS_GAPS = {
    name: ClassGap("f32", "ulp", _FUSED_FIT)
    for name in ("single_scan", "single_scan_steps",
                 "fleet_event_adaptive_threshold",
                 "fleet_event_batched_rebalance", "fleet_event_chaos_flap",
                 "fleet_event_cost_aware_wan", "fleet_event_sharded_static")}


# the fused fit's path only (use_kernel True): held to the reference's own
# kernel path
KERNEL_PATH_REPORTS = {
    "fleet_scan_chaos_region": (
        "the fused fit moves allocations of this 48-window golden: the "
        "reference's kernel path gives 1053064 WAN bytes, its CPU path "
        "1053280, and the port gives each on the same path (ROADMAP.md "
        "queue 3)"),
    "fleet_event_adaptive_threshold": (
        "the fused fit moves this golden's floats past f32 in the "
        "reference itself (its counters agree): its kernel path gives a "
        "worst-stream VAR NRMSE of 3.769237, its CPU path 3.769494 "
        "(ROADMAP.md queue 3)"),
}


def kernel_path(device=None, use_kernel: Optional[bool] = None) -> bool:
    """Whether a run takes the CUDA kernels' path (the fused fit)."""
    return use_kernel is True or (use_kernel is None
                                  and resolve_device(device).type == "cuda")


@dataclasses.dataclass(frozen=True)
class SweepScenario:
    """One committed scenario file, config loaded by the port."""

    name: str
    tolerance: str
    tags: tuple
    config: "ScenarioConfig"
    path: Path

    def matches(self, pattern: Optional[str]) -> bool:
        if not pattern:
            return True
        return pattern in self.name or pattern in self.tags


def load_scenario_file(path: Path) -> SweepScenario:
    from repro_torch.api.scenario import ScenarioConfig
    d = json.loads(Path(path).read_text())
    for field in ("name", "tolerance", "scenario"):
        if field not in d:
            raise ValueError(f"{path}: scenario file missing {field!r}")
    if d["name"] != Path(path).stem:
        raise ValueError(f"{path}: name {d['name']!r} != filename stem")
    if d["tolerance"] not in TOLERANCE_CLASSES:
        raise ValueError(f"{path}: unknown tolerance {d['tolerance']!r}; "
                         f"known: {sorted(TOLERANCE_CLASSES)}")
    cfg = ScenarioConfig.from_dict(d["scenario"])   # registry validation
    return SweepScenario(name=d["name"], tolerance=d["tolerance"],
                         tags=tuple(d.get("tags", ())), config=cfg,
                         path=Path(path))


def load_scenarios(directory: Path = SCENARIO_DIR) -> list[SweepScenario]:
    """Every scenario file, sorted by name; raises on the first bad one."""
    files = sorted(Path(directory).glob("*.json"))
    if not files:
        raise FileNotFoundError(f"no scenario files in {directory}")
    return [load_scenario_file(f) for f in files]


def not_ported(s: SweepScenario) -> Optional[str]:
    """The ROADMAP item that ports ``s``, or None when the port runs it."""
    from repro_torch.api.experiment import check_scenario
    try:
        check_scenario(s.config)
    except NotImplementedError as exc:
        m = re.search(r"ROADMAP\.md: (.*)\)", str(exc))
        return m.group(1) if m else str(exc)
    return None


def run_scenario(s: SweepScenario, *, device=None,
                 use_kernel: Optional[bool] = None) -> dict:
    """Execute one scenario in the port and serialize its RunReport."""
    from repro_torch.api.experiment import Experiment
    report = Experiment.from_scenario(s.config, use_kernel=use_kernel,
                                      device=device).run()
    return serialize_report(report, name=s.name, tolerance=s.tolerance)


def report_path(s: SweepScenario, report_dir: Path = REPORT_DIR) -> Path:
    return Path(report_dir) / f"{s.name}.json"


def golden_report_path(s: SweepScenario, report_dir: Path = REPORT_DIR, *,
                       use_kernel: Optional[bool] = None) -> Path:
    """The report ``s`` is held to: its kernel-path report when the fit is
    the fused one and :data:`KERNEL_PATH_REPORTS` lists it, else its
    report."""
    if use_kernel is True and s.name in KERNEL_PATH_REPORTS:
        return report_path(s, KERNEL_REPORT_DIR)
    return report_path(s, report_dir)


def check_scenarios(scenarios: list[SweepScenario],
                    report_dir: Path = REPORT_DIR, *, device=None,
                    use_kernel: Optional[bool] = None,
                    log=print) -> list[Drift]:
    """Run every scenario and diff against its port-owned report, each
    held to its class (:data:`KERNEL_CLASS_GAPS` and
    :data:`KERNEL_PATH_REPORTS` on the kernels' path)."""
    gaps = KERNEL_CLASS_GAPS if kernel_path(device, use_kernel) else {}
    drifts = []
    for s in scenarios:
        rp = golden_report_path(s, report_dir, use_kernel=use_kernel)
        if not rp.exists():
            drifts.append(Drift(s.name, "golden", "<missing file>",
                                str(rp), "presence"))
            log(f"  {s.name:<34} MISSING REPORT")
            continue
        golden = json.loads(rp.read_text())
        gap = gaps.get(s.name)
        held = golden["tolerance"] if gap is None else gap.meets
        d = diff_reports(dict(golden, tolerance=held),
                         run_scenario(s, device=device,
                                      use_kernel=use_kernel))
        drifts += d
        classes = (f"[{held}]" if gap is None else
                   f"[held {held}; golden {golden['tolerance']}: kernel "
                   f"path]")
        if rp.parent == KERNEL_REPORT_DIR:
            classes += " (the reference's kernel path)"
        log(f"  {s.name:<34} {'ok' if not d else f'{len(d)} drift(s)'}"
            f"  {classes}")
    return drifts


def run_sweep(*, mode: str = "check", pattern: Optional[str] = None,
              scenario_dir: Path = SCENARIO_DIR,
              report_dir: Path = REPORT_DIR, device=None,
              use_kernel: Optional[bool] = None, log=print) -> int:
    """The CLI body; returns the process exit code (0 ok, 1 drift, 2
    usage)."""
    scenarios = load_scenarios(scenario_dir)    # loading == lint
    if mode == "lint":
        log(f"sweep lint OK: {len(scenarios)} scenario file(s) load and "
            f"name only registered components")
        return 0
    if mode == "list":
        for s in scenarios:
            mark = "*" if s.matches(pattern) else " "
            item = not_ported(s)
            where = "" if item is None else f"  not ported: {item}"
            log(f" {mark} {s.name:<34} [{s.tolerance}] "
                f"tags={','.join(s.tags) or '-'}{where}")
        return 0
    selected = [s for s in scenarios if s.matches(pattern)]
    if not selected:
        log(f"no scenario matches filter {pattern!r}")
        return 2
    runnable, skipped = [], []
    for s in selected:
        item = not_ported(s)
        (runnable if item is None else skipped).append((s, item))
    for s, item in skipped:
        log(f"  {s.name:<34} not ported  ({item})")
    if kernel_path(device, use_kernel):
        for name, gap in sorted(KERNEL_CLASS_GAPS.items()):
            if any(s.name == name for s, _ in runnable):
                log(f"  class gap on the kernel path: {name} is held to "
                    f"{gap.meets}, its golden names {gap.golden}: "
                    f"{gap.reason}")
    if use_kernel is True:
        for name, reason in sorted(KERNEL_PATH_REPORTS.items()):
            if any(s.name == name for s, _ in runnable):
                log(f"  on the kernel path {name} is held to the reference's"
                    f" kernel path: {reason}")
    drifts = check_scenarios([s for s, _ in runnable], report_dir,
                             device=device, use_kernel=use_kernel, log=log)
    if drifts:
        log(format_drift_table(drifts))
        return 1
    log(f"sweep OK: {len(runnable)} scenario(s) checked, no number changed;"
        f" {len(skipped)} not ported"
        + (": " + ", ".join(s.name for s, _ in skipped) if skipped else ""))
    return 0
