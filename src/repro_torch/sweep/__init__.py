"""The port's golden sweep (``python -m repro_torch.sweep``).

Runs the reference's committed scenarios (``tests/goldens/scenarios/``)
through :class:`repro_torch.api.Experiment`, serializes each report as
the reference does (:mod:`repro_torch.sweep.report`) and diffs it
against the port-owned reference reports in ``tests/torch_goldens/``
(:mod:`repro_torch.sweep.diff`).  See :mod:`repro_torch.sweep.runner`
for what differs from the reference's sweep.
"""
from repro_torch.sweep.diff import (Drift, TOLERANCE_CLASSES, diff_reports,
                                    format_drift_table)
from repro_torch.sweep.report import REPORT_SCHEMA_VERSION, serialize_report
from repro_torch.sweep.runner import (KERNEL_CLASS_GAPS, ClassGap,
                                      SweepScenario, check_scenarios,
                                      kernel_path, load_scenario_file,
                                      load_scenarios, not_ported,
                                      run_scenario, run_sweep)

__all__ = [
    "Drift", "TOLERANCE_CLASSES", "diff_reports", "format_drift_table",
    "REPORT_SCHEMA_VERSION", "serialize_report",
    "KERNEL_CLASS_GAPS", "ClassGap", "SweepScenario", "check_scenarios",
    "kernel_path", "load_scenario_file", "load_scenarios", "not_ported",
    "run_scenario", "run_sweep",
]
