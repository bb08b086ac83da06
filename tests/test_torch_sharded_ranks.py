"""The port's sharded runtimes over gloo ranks on the CPU, held to its
unsharded runs bitwise.

JAX-free: the ranks import this module by name, so it imports nothing of
the JAX package.  One subprocess for each world size (W = 2 and W = 4,
started together) spawns W ranks (``torch.multiprocessing``, the spawn
method) on a gloo group; each rank runs every case below through the
normal entry points and writes its results to an ``.npz``.  The tests
then hold every rank's results to rank 0's (every rank returns the same
report) and to the same scenarios run here without a process group.

Cases (E = 6 sites, k = 4 streams, N = 64; at W = 4, E = 6 pads to 8):
``fleet_scan_sharded`` under static budgets, rebalance, chaos
(``fleet_scan_chaos_join``'s faults) and adaptive re-planning
(``fleet_scan_adaptive_ph``'s page_hinkley gate); a chaos run killed at
window 3 of 6 and resumed from its checkpoint on the other runtime, both
ways; ``fleet_event_sharded_static`` (E = 4: one site a rank at W = 4);
and ``ShardedEngine.plan_fleet`` at E = 12 and E = 10 with a straggler.
"""
import datetime
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = ROOT / "tests" / "goldens" / "scenarios"
WORLDS = (2, 4)
# each world's subprocess, ranks included; a rank that fails or hangs
# fails the run (the ranks' own collectives time out sooner)
RUN_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
CUT = 3


def _golden(name: str) -> dict:
    return json.loads((SCENARIOS / f"{name}.json").read_text())["scenario"]


def scan_cases() -> dict:
    """Name -> scenario dict of every sharded scan case."""
    base = _golden("fleet_scan_sharded")
    static = dict(base, controller=dict(base["controller"], mode="static"))
    chaos = dict(base, chaos=_golden("fleet_scan_chaos_join")["chaos"])
    adaptive = dict(_golden("fleet_scan_adaptive_ph"),
                    runtime="scan_sharded")
    return {"static": static, "rebalance": base, "chaos": chaos,
            "adaptive": adaptive}


def _experiment(d: dict, **change):
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    return Experiment.from_scenario(ScenarioConfig.from_dict(dict(d,
                                                                  **change)),
                                    device="cpu")


def _state_leaves(state, prefix: str) -> dict:
    from repro_torch.ckpt.checkpoint import flatten
    return {f"{prefix}state{path}": a for path, a in flatten(state).items()}


def report_arrays(rep, prefix: str) -> dict:
    """Everything a sharded run must reproduce, as named host arrays."""
    raw = rep.raw
    out = {f"{prefix}{c}": np.asarray(getattr(rep, c)) for c in (
        "wan_bytes", "wan_cost", "full_bytes", "gaps", "revisions",
        "late_drops", "duplicates")}
    for q, v in rep.nrmse_per_stream.items():
        out[f"{prefix}nrmse_per_stream/{q}"] = np.asarray(v)
        out[f"{prefix}nrmse/{q}"] = np.asarray(rep.nrmse[q])
    out[f"{prefix}budget_history"] = np.asarray(raw["budget_history"])
    for key in ("bytes_history", "controller_demand", "planner_invocations",
                "plans_reused", "drift_fires"):
        if key in raw:
            out[f"{prefix}{key}"] = np.asarray(raw[key])
    if "final_state" in raw:
        out.update(_state_leaves(raw["final_state"], prefix))
    return out


def resume_arrays(head_runtime: str, tail_runtime: str, ckpt_dir,
                  prefix: str) -> dict:
    """The chaos case run to window CUT on ``head_runtime``, checkpointed,
    restored and run to its end on ``tail_runtime``."""
    from repro_torch.ckpt import latest_step, restore, save
    d = scan_cases()["chaos"]
    ex = _experiment(d, runtime=head_runtime)
    windows = ex.make_windows()
    head = ex.run(windows, n_windows=CUT)
    save(head.raw["final_state"], CUT, ckpt_dir)
    state = restore(ckpt_dir, latest_step(ckpt_dir),
                    head.raw["final_state"], device="cpu")
    tail = _experiment(d, runtime=tail_runtime).run(
        windows, n_windows=len(windows) - CUT, state=state)
    out = report_arrays(tail, prefix)
    out[f"{prefix}head_wan_bytes"] = np.asarray(head.wan_bytes)
    return out


def plan_arrays(n_sites: int, prefix: str) -> dict:
    """``ShardedEngine.plan_fleet`` at E = n_sites, k = 4, N = 64, one
    straggled stream."""
    from repro_torch.api.registry import ENGINES
    from repro_torch.core.types import PlannerConfig
    from repro_torch.data.streams import fleet_like, fleet_windows
    import repro_torch.planning  # noqa: F401  (fills ENGINES)
    vals, _ = fleet_like(n_sites=n_sites, n_regions=3, k=4, n_points=128,
                         seed=1)
    w = fleet_windows(vals, 64)[0]
    counts = np.full((n_sites, 4), 64, np.int64)
    counts[2, 1] = 0
    budgets = np.full(n_sites, 0.25 * 4 * 64)
    cfg = PlannerConfig(solver="closed_form")
    plan = ENGINES.get("sharded").plan_fleet(w, counts, budgets, cfg,
                                             device="cpu")
    return {f"{prefix}{f}": a for f, a in plan.items()}


def all_arrays(ckpt_dir) -> dict:
    """Every case, as one rank (or the unsharded run here) computes it."""
    out = {}
    for name, d in scan_cases().items():
        out.update(report_arrays(_experiment(d).run(), f"{name}/"))
    ckpt = pathlib.Path(ckpt_dir)
    out.update(resume_arrays("scan_sharded", "scan", ckpt / "to_scan",
                             "resume_to_scan/"))
    out.update(resume_arrays("scan", "scan_sharded", ckpt / "to_sharded",
                             "resume_to_sharded/"))
    out.update(report_arrays(_experiment(
        _golden("fleet_event_sharded_static")).run(), "event/"))
    for e in (12, 10):
        out.update(plan_arrays(e, f"plan_fleet_{e}/"))
    return out


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        arrays = all_arrays(f"{out_dir}/ckpt_rank{rank}")
        np.savez(f"{out_dir}/rank{rank}.npz", **arrays)
    finally:
        dist.destroy_process_group()


def launch(world: int, out_dir: str) -> None:
    """Spawn ``world`` gloo ranks, each running every case; raises if a
    rank fails (the others are then terminated)."""
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(world, out_dir), nprocs=world, join=True)


# --------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{W: [rank 0's arrays, rank 1's, ...]} from one subprocess for each
    world size, both started at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for w in WORLDS:
        out = tmp_path_factory.mktemp(f"world{w}")
        prog = f"import {__name__} as m; m.launch({w}, {str(out)!r})"
        # a session of its own: a timeout kills the ranks with it
        procs[w] = (out, subprocess.Popen(
            [sys.executable, "-c", prog], cwd=pathlib.Path(__file__).parent,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    got = {}
    for w, (out, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, p in procs.values():
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            raise
        assert proc.returncode == 0, log[-4000:]
        got[w] = []
        for r in range(w):
            with np.load(out / f"rank{r}.npz") as data:
                got[w].append(dict(data))
    return got


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The same cases here, with no process group: the scan cases on
    ``runtime="scan"``, the event golden and the plans at world size 1."""
    out = {}
    for name, d in scan_cases().items():
        out.update(report_arrays(_experiment(d, runtime="scan").run(),
                                 f"{name}/"))
    d = scan_cases()["chaos"]
    full = report_arrays(_experiment(d, runtime="scan").run(), "")
    for prefix in ("resume_to_scan/", "resume_to_sharded/"):
        out.update({f"{prefix}{key}": v for key, v in full.items()})
    out.update(report_arrays(_experiment(
        _golden("fleet_event_sharded_static")).run(), "event/"))
    for e in (12, 10):
        out.update(plan_arrays(e, f"plan_fleet_{e}/"))
    return out


def _same(got: dict, want: dict, prefix: str, skip=()) -> None:
    keys = sorted(k for k in want if k.startswith(prefix)
                  and k[len(prefix):] not in skip)
    assert keys
    assert sorted(k for k in got if k.startswith(prefix)
                  and k[len(prefix):] not in skip) == keys
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_report(ranks, world):
    first = ranks[world][0]
    for other in ranks[world][1:]:
        _same(other, first, "")


@pytest.mark.parametrize("case", ["static", "rebalance", "chaos",
                                  "adaptive"])
@pytest.mark.parametrize("world", WORLDS)
def test_the_sharded_scan_is_the_unsharded_scan(ranks, unsharded, world,
                                                case):
    """Counters, byte and budget histories, every NRMSE, the controller's
    demand, the adaptive counters and the final state, bitwise."""
    _same(ranks[world][0], unsharded, f"{case}/")


@pytest.mark.parametrize("world", WORLDS)
def test_the_adaptive_gate_decides_as_the_unsharded_one(ranks, unsharded,
                                                        world):
    got, want = ranks[world][0], unsharded
    for key in ("planner_invocations", "plans_reused", "drift_fires"):
        assert int(got[f"adaptive/{key}"]) == int(want[f"adaptive/{key}"])
    assert 1 < int(want["adaptive/planner_invocations"]) < 12


@pytest.mark.parametrize("direction", ["resume_to_scan",
                                       "resume_to_sharded"])
@pytest.mark.parametrize("world", WORLDS)
def test_a_checkpoint_resumes_on_the_other_runtime(ranks, unsharded, world,
                                                   direction):
    """Killed at window 3 of 6 on one runtime, resumed from the checkpoint
    on the other: the tail's history and final state are the
    uninterrupted run's, and the two halves' bytes add up."""
    got = ranks[world][0]
    n = len(got[f"{direction}/bytes_history"])
    assert n == 6 - CUT
    for key in ("bytes_history", "budget_history"):
        np.testing.assert_array_equal(got[f"{direction}/{key}"],
                                      unsharded[f"{direction}/{key}"][CUT:])
    assert int(got[f"{direction}/head_wan_bytes"]) \
        + int(got[f"{direction}/wan_bytes"]) \
        == int(unsharded[f"{direction}/wan_bytes"])
    _same(got, unsharded, f"{direction}/state")


@pytest.mark.parametrize("world", WORLDS)
def test_the_sharded_engine_drives_the_event_loop(ranks, unsharded, world):
    """``fleet_event_sharded_static`` (E = 4): at W = 4 every rank plans
    one site, and still takes the fleet's fit, not the one-site one."""
    _same(ranks[world][0], unsharded, "event/")


@pytest.mark.parametrize("n_sites", [12, 10])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_plan_fleet_is_the_batched_one(ranks, unsharded, world,
                                               n_sites):
    _same(ranks[world][0], unsharded, f"plan_fleet_{n_sites}/")
