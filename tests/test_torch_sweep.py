"""The port's golden sweep (``repro_torch.sweep``) against the reference's.

* ``serialize_report`` and ``diff_reports`` give the reference's dicts and
  ``Drift`` rows on the same inputs, under each tolerance class.
* The committed port-owned reports (``tests/torch_goldens/reports/``)
  are what the live reference gives now, regenerated through
  ``scripts/torch_reference_reports.py`` (``check_live_reference``, run
  by ``test_torch_sweep_live_scan.py``, ``..._live_fleet_event.py`` and
  ``..._live_single_event.py``, one group of goldens each).
* ``python -m repro_torch.sweep --check --filter scan --device cpu``
  checks the seven scan goldens the port runs, each in its own class, and
  names the one it cannot run yet; with no filter it checks those, the
  five fleet event goldens and the seven single-edge event goldens, and
  names the two it cannot run yet, each with its ROADMAP item
  (``test_torch_sweep_scan_cli.py`` and ``test_torch_sweep_all_cli.py``
  run the two, each in a file of its own so that they can run on
  separate workers).
* The single-edge goldens meet their ``ulp`` class because the port sums
  and solves the cubic fit's normal equations in the reference's order;
  the pieces of that order are held bitwise here.  With the kernels on,
  the fit is the fused one and meets ``f32`` only: each entry of the
  sweep's ``KERNEL_CLASS_GAPS`` drifts under its golden's class and
  passes under the recorded one, and each entry of its
  ``KERNEL_PATH_REPORTS`` drifts in its counters against the CPU report
  and not at all against the reference's own kernel path.
"""
import dataclasses
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sweep import diff as ref_diff
from repro.sweep import report as ref_report
from repro_torch.core.stats import lane_sum, lu_solve4, sqrt
from repro_torch.sweep import diff, report, runner

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPORTS = ROOT / "tests" / "torch_goldens" / "reports"
SCAN_GOLDENS = ["fleet_scan", "fleet_scan_adaptive_ph",
                "fleet_scan_chaos_join", "fleet_scan_chaos_region",
                # the sharded scan runtime (world size 1 here)
                "fleet_scan_sharded",
                "fleet_scan_steps_static", "single_scan", "single_scan_steps"]
EVENT_GOLDENS = ["fleet_event_adaptive_threshold",
                 "fleet_event_batched_rebalance", "fleet_event_chaos_flap",
                 "fleet_event_cost_aware_wan",
                 # the host engine: the host planner at every site
                 "fleet_event_host_engine",
                 # the sharded engine (world size 1 here)
                 "fleet_event_sharded_static"]
# one edge on the event clock, the host planner and its f64 IPM (a
# baseline sampler in place of the planner in baseline_srs)
SINGLE_EVENT_GOLDENS = [f"single_event_{n}" for n in (
    "baseline_srs", "cubic", "drop_gaps", "jitter_bandwidth",
    "latency_revise", "linear_alpha", "retransmit")]
PORTED = sorted(SCAN_GOLDENS + EVENT_GOLDENS + SINGLE_EVENT_GOLDENS)
# the scan goldens the port cannot run yet, with their item: none since
# sharding was ported
NOT_PORTED = {}
# every golden the port cannot run yet, with its item: none
ALL_NOT_PORTED = {**NOT_PORTED}


def golden_class(name: str) -> str:
    """The tolerance class the CPU sweep holds golden ``name`` to."""
    if name.startswith("fleet_scan"):
        return "f32"
    return "exact" if name.startswith("single_event") else "ulp"
CLASSES = sorted(ref_diff.TOLERANCE_CLASSES)


def _script():
    path = ROOT / "scripts" / "torch_reference_reports.py"
    spec = importlib.util.spec_from_file_location("torch_reference_reports",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_report(seed: int, adaptive: bool):
    """A RunReport-shaped object with every field the serializer reads."""
    rng = np.random.default_rng(seed)
    raw = {"gaps": 2, "revisions": 1, "late_drops": 0, "duplicates": 3,
           "retransmits": 4,
           "window_age_ms": rng.uniform(0, 9, (5, 3)),
           "revised_windows": rng.uniform(size=5) > 0.5,
           "budget_history": rng.integers(2, 90, (5, 3)).astype(np.float32)}
    if adaptive:
        raw.update(planner_invocations=6, plans_reused=6, drift_fires=7,
                   detection_lag_windows=1.5)
    table = rng.uniform(0, 1, (3, 4))
    table[1, 2] = np.nan
    return types.SimpleNamespace(
        n_sites=3, wan_bytes=21096, full_bytes=73728,
        wan_bytes_by_region={"region1": 9000, "region0": 12096},
        nrmse={"AVG": 0.0235, "VAR": float("nan"), "MAX": float("inf")},
        nrmse_at_query={"AVG": 0.0235},
        wan_cost=1234.5, wan_cost_by_region={"region0": 1.0,
                                             "region1": 1233.5},
        freshness_ms={"p50_ms": 0.0, "p99_ms": 0.0},
        region_nrmse={"region0": {"AVG": 0.01}, "region1": {"AVG": 0.03}},
        nrmse_per_stream={"AVG": table, "VAR": table * 2},
        raw=raw)


@pytest.mark.parametrize("tolerance", CLASSES)
@pytest.mark.parametrize("adaptive", [False, True])
def test_serialize_report_is_the_reference_serializer(tolerance, adaptive):
    rep = _fake_report(3, adaptive)
    got = report.serialize_report(rep, name="x", tolerance=tolerance)
    want = ref_report.serialize_report(rep, name="x", tolerance=tolerance)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert ("planner_invocations" in got["counters"]) == adaptive


def _perturbed(golden: dict) -> dict:
    cur = json.loads(json.dumps(golden))
    cur["counters"]["wan_bytes"] += 1
    cur["floats"]["nrmse/AVG"] *= 1 + 5e-10          # inside ulp
    cur["floats"]["nrmse_at_query/AVG"] *= 1 + 5e-6  # inside f32 only
    cur["floats"]["wan_cost"] *= 1 + 1e-3            # outside every class
    cur["floats"]["freshness_ms/p50_ms"] = None
    del cur["floats"]["region_nrmse/region0/AVG"]
    cur["floats"]["extra"] = 1.0
    s = cur["streams"]["nrmse_per_stream/AVG"]
    s["sha256"] = "0" * 64
    s["mean"] *= 1 + 2e-5
    s["max"] *= 1 + 1e-2
    cur["streams"]["budget_history"]["sha256"] = "f" * 64
    cur["streams"]["revised_windows"]["shape"] = [6]
    return cur


@pytest.mark.parametrize("tolerance", CLASSES)
def test_diff_reports_is_the_reference_diff(tolerance):
    golden = ref_report.serialize_report(_fake_report(4, True), name="x",
                                         tolerance=tolerance)
    current = _perturbed(golden)
    got = diff.diff_reports(golden, current)
    want = ref_diff.diff_reports(golden, current)
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    assert len(got) > 5
    assert diff.format_drift_table(got) == ref_diff.format_drift_table(want)
    assert diff.diff_reports(golden, golden) == []
    with pytest.raises(ValueError, match="unknown tolerance"):
        diff.diff_reports(dict(golden, tolerance="loose"), current)


def check_live_reference(tmp_path, names: list) -> None:
    """Regenerate the reports of goldens ``names`` with the live reference:
    the committed files are byte for byte what it gives now, the kernel
    path's too for those of them that have one, and the provenance names
    them.  The three ``test_torch_sweep_live_*.py`` files each check one
    group (scan, fleet event, single-edge event), so that under ``--dist
    loadfile`` the groups regenerate on separate workers; together they
    cover every committed report."""
    mod = _script()
    assert [s.name for s in mod.ported_goldens()] == PORTED
    assert sorted(SCAN_GOLDENS + EVENT_GOLDENS
                  + SINGLE_EVENT_GOLDENS) == PORTED
    assert sorted(p.name for p in REPORTS.iterdir()) == \
        [f"{n}.json" for n in PORTED]
    assert sorted(p.name for p in runner.KERNEL_REPORT_DIR.iterdir()) == \
        [f"{n}.json" for n in sorted(runner.KERNEL_PATH_REPORTS)]
    mod.generate(tmp_path, names=names, log=lambda *_: None)
    written = sorted(p.name for p in (tmp_path / "reports").iterdir())
    assert written == sorted(f"{n}.json" for n in names)
    for name in written:
        assert (tmp_path / "reports" / name).read_text() == \
            (REPORTS / name).read_text(), name
    kernel_names = sorted(set(names) & set(runner.KERNEL_PATH_REPORTS))
    kernel_dir = tmp_path / "kernel_reports"
    kernel = (sorted(p.name for p in kernel_dir.iterdir())
              if kernel_dir.exists() else [])
    assert kernel == [f"{n}.json" for n in kernel_names]
    for name in kernel:
        assert (kernel_dir / name).read_text() == \
            (runner.KERNEL_REPORT_DIR / name).read_text(), name
    prov = json.loads((tmp_path / "PROVENANCE.json").read_text())
    assert prov["jax"] == jax.__version__
    assert prov["scenarios"] == sorted(names)
    assert prov["kernel_path_scenarios"] == kernel_names


def test_sweep_list_lint_and_usage():
    logged = []
    assert runner.run_sweep(mode="lint", log=logged.append) == 0
    assert "21 scenario file(s)" in logged[-1]
    logged.clear()
    assert runner.run_sweep(mode="list", pattern="scan",
                            log=logged.append) == 0
    assert len(logged) == 21
    marked = [ln.split()[1] for ln in logged if ln.startswith(" *")]
    assert marked == sorted([*SCAN_GOLDENS, *NOT_PORTED])
    assert sum("not ported" in ln for ln in logged) == len(ALL_NOT_PORTED) \
        == 0
    assert not any("'Event path'" in ln for ln in logged)
    from repro_torch.sweep.__main__ import main
    assert main(["--check", "--filter", "no_such_scenario",
                 "--device", "cpu"]) == 2
    with pytest.raises(SystemExit) as exc:
        main(["--update"])
    assert exc.value.code == 2


@pytest.mark.parametrize("field,value", [
    ("counters", "wan_bytes"), ("floats", "nrmse/AVG")])
def test_sweep_reports_a_drift(tmp_path, field, value):
    """A report that disagrees with the port by one counter, or by a float
    beyond the class, fails the check with the field named."""
    for p in REPORTS.iterdir():
        (tmp_path / p.name).write_text(p.read_text())
    path = tmp_path / "single_scan_steps.json"
    rep = json.loads(path.read_text())
    rep[field][value] = (rep[field][value] + 1 if field == "counters"
                         else rep[field][value] * (1 + 1e-6))
    path.write_text(json.dumps(rep))
    logged = []
    code = runner.run_sweep(pattern="single_scan_steps", report_dir=tmp_path,
                            device="cpu", log=logged.append)
    assert code == 1
    assert f"{field}:{value}" in logged[-1]


@pytest.fixture(scope="module")
def kernel_path_reports():
    """The port's reports of the two maps' scenarios with the kernels'
    path on (on the CPU: the fused fit over the plain moments)."""
    return {name: runner.run_scenario(
        runner.load_scenario_file(runner.SCENARIO_DIR / f"{name}.json"),
        device="cpu", use_kernel=True)
        for name in [*runner.KERNEL_CLASS_GAPS, *runner.KERNEL_PATH_REPORTS]}


def _kernel_path_golden(name: str) -> dict:
    """The report a scenario is held to on the fused fit's path."""
    s = runner.load_scenario_file(runner.SCENARIO_DIR / f"{name}.json")
    return json.loads(runner.golden_report_path(
        s, use_kernel=True).read_text())


@pytest.mark.parametrize("name", sorted(runner.KERNEL_CLASS_GAPS))
def test_kernel_class_gap_entry_is_needed_and_enough(kernel_path_reports,
                                                     name):
    gap = runner.KERNEL_CLASS_GAPS[name]
    golden = _kernel_path_golden(name)
    assert golden["tolerance"] == gap.golden
    current = kernel_path_reports[name]
    drifts = diff.diff_reports(golden, current)
    assert drifts, f"{name} meets {gap.golden} now: remove its entry"
    assert not any(d.field.startswith("counters:") for d in drifts)
    assert diff.diff_reports(dict(golden, tolerance=gap.meets),
                             current) == []
    assert runner.kernel_path("cpu", True)
    assert not runner.kernel_path("cpu", None)


@pytest.mark.parametrize("name", sorted(runner.KERNEL_PATH_REPORTS))
def test_kernel_path_report_entry_is_needed_and_enough(kernel_path_reports,
                                                       name):
    """Against the CPU report the port's kernel path drifts in its
    counters, or (for a scenario also held to a looser class there) in its
    floats beyond that class; against the reference's kernel path it
    drifts in nothing, in the class it is held to."""
    golden = json.loads((REPORTS / f"{name}.json").read_text())
    current = kernel_path_reports[name]
    gap = runner.KERNEL_CLASS_GAPS.get(name)
    held = golden["tolerance"] if gap is None else gap.meets
    drifts = diff.diff_reports(dict(golden, tolerance=held), current)
    if gap is None:
        assert any(d.field.startswith("counters:") for d in drifts), \
            f"{name}'s kernel path gives the CPU report's counters now"
    else:
        assert drifts, f"{name}'s kernel path meets the CPU report now"
        assert not any(d.field.startswith("counters:") for d in drifts)
    kernel = json.loads(
        (runner.KERNEL_REPORT_DIR / f"{name}.json").read_text())
    assert kernel["tolerance"] == golden["tolerance"]
    assert diff.diff_reports(dict(kernel, tolerance=held), current) == []
    s = runner.load_scenario_file(runner.SCENARIO_DIR / f"{name}.json")
    assert runner.golden_report_path(s, use_kernel=True).parent == \
        runner.KERNEL_REPORT_DIR
    for use_kernel in (None, False):        # the fit is not the fused one
        assert runner.golden_report_path(
            s, use_kernel=use_kernel).parent == runner.REPORT_DIR


# ------------------------------------- the fit's order (the ulp class)

def _dot(lhs, rhs, contract):
    return np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (contract, ((0,), (0,)))))(lhs, rhs))


@pytest.mark.parametrize("n", [128, 256, 4096, 33])
def test_one_site_normal_equations_are_summed_as_the_reference(n):
    """One site's X^T X (four chains) and X^T y (eight) against the dot
    the reference compiles for them."""
    rng = np.random.default_rng(n)
    ft = rng.standard_normal((5, 4, n)).astype(np.float32)
    y = rng.standard_normal((5, n)).astype(np.float32)
    f = np.ascontiguousarray(ft.transpose(0, 2, 1))
    t = torch.as_tensor(ft)
    assert np.array_equal(
        lane_sum(t[:, :, None, :], t[:, None, :, :], 4).numpy(),
        _dot(ft, f, ((2,), (1,))))
    assert np.array_equal(lane_sum(t, torch.as_tensor(y)[:, None, :],
                                   8).numpy(), _dot(ft, y, ((2,), (1,))))


def test_a_fleet_s_normal_equations_are_one_chain():
    rng = np.random.default_rng(6)
    f = rng.standard_normal((6, 4, 64, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.lax.dot_general(
        a, a, (((2,), (2,)), ((0, 1), (0, 1)))))(f))
    t = torch.as_tensor(f).transpose(-1, -2)
    assert np.array_equal(
        lane_sum(t[..., :, None, :], t[..., None, :, :], 1).numpy(), want)


@pytest.mark.parametrize("kind", ["normal_equations", "random"])
def test_lu_solve4_is_lapack_order(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        a = rng.standard_normal((300, 4, 4)).astype(np.float32)
    else:
        u = (rng.standard_normal((300, 256))
             * rng.uniform(0.5, 2.0, (300, 1))).astype(np.float32)
        f = np.stack([np.ones_like(u), u, u * u, u * u * u], -1)
        a = (np.einsum("bni,bnj->bij", f, f)
             + np.float32(1e-6) * np.eye(4)).astype(np.float32)
    b = (rng.standard_normal((300, 4)) * 50).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.linalg.solve))(a, b))
    got = lu_solve4(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.array_equal(got, want)


def test_sqrt_is_rounded_correctly():
    rng = np.random.default_rng(8)
    x = rng.uniform(1e-3, 1e4, 100_000).astype(np.float32)
    assert np.array_equal(sqrt(torch.as_tensor(x)).numpy(), np.sqrt(x))
