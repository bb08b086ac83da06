"""The port's checkpoints against the reference's (``repro.ckpt``).

The on-disk format is the reference's (``manifest.json`` + ``data.npz``,
leaves keyed as ``jax.tree_util.keystr`` writes them), so a checkpoint
written by either package restores into the other.  A chaos run's carry
checkpointed mid-outage and resumed gives the uninterrupted run's byte and
budget histories, served memory and final state bitwise, in the port, from
a reference checkpoint, and in the reference from a port checkpoint.  The
reference runs once, in a module fixture.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.ckpt import latest_step as ref_latest_step
from repro.ckpt import restore as ref_restore
from repro.ckpt import save as ref_save
from repro.runtime.scan import ScanRuntime as RefScanRuntime
from repro_torch.api.experiment import Experiment
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.chaos import make_chaos_carry
from repro_torch.ckpt import (CheckpointManager, flatten, latest_step,
                              restore, save)
from repro_torch.runtime.state import init_state

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
NAME = "fleet_scan_chaos_join"      # site 0 joins at window 2, site 4 dark
CUT = 3                             # from 3 on: the cut lands in the flap


def _scenario() -> dict:
    return json.loads((GOLDENS / f"{NAME}.json").read_text())["scenario"]


def _port_runtime():
    return Experiment.from_scenario(ScenarioConfig.from_dict(_scenario()),
                                    device="cpu").runtime


def _template(e=6, k=4):
    st = init_state(e, k, 0.0, device="cpu")
    st.chaos = make_chaos_carry(e, k, ("AVG", "VAR", "MIN", "MAX"),
                                device="cpu")
    return st


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's uninterrupted run and its first CUT windows."""
    sc = RefScenario.from_dict(_scenario())
    windows = RefExperiment.from_scenario(sc).make_windows()
    full = RefScanRuntime.from_scenario(sc).run(windows)
    head = RefScanRuntime.from_scenario(sc).run(windows, n_windows=CUT)
    return [np.asarray(w) for w in windows], full, head


def _assert_resumed(tail, full):
    for k in ("bytes_history", "budget_history", "liveness"):
        assert np.array_equal(np.asarray(tail[k]),
                              np.asarray(full[k])[CUT:]), k
    got, want = _flat(tail["final_state"]), _flat(full["final_state"])
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def _ref_flat(state) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _flat(state) -> dict:
    """A port state's or a reference state's leaves by checkpoint key."""
    if isinstance(state.window_id, int):
        return flatten(state)
    return _ref_flat(state)


def test_keys_are_the_references(ref_runs):
    """The port's leaf keys, shapes and dtypes are those the reference
    writes for the same state."""
    _, _, head = ref_runs
    want = _ref_flat(head["final_state"])
    got = flatten(_template())
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert got[".window_id"].dtype == np.int32
    assert ".chaos.served['AVG']" in got


def test_round_trip(tmp_path):
    st = _template()
    st.window_id = 3
    st.controller.demand = torch.linspace(0.1, 1.0, 6)
    st.chaos.live = torch.tensor([True, False, True, True, False, True])
    st.chaos.served["VAR"][1] = 2.5
    path = save(st, 3, tmp_path)
    assert path.name == "step_00000003"
    man = json.loads((path / "manifest.json").read_text())
    assert man["complete"] and man["step"] == 3
    assert latest_step(tmp_path) == 3
    out = restore(tmp_path, 3, _template(), device="cpu")
    assert out.window_id == 3 and isinstance(out.window_id, int)
    a, b = flatten(st), flatten(out)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
        assert a[k].dtype == b[k].dtype, k
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(tmp_path, 3, _template(e=5), device="cpu")


def test_torn_manifest_is_ignored(tmp_path):
    save(_template(), 1, tmp_path)
    save(_template(), 2, tmp_path)
    (tmp_path / "step_00000002" / "manifest.json").write_text("{\"step\": 2,")
    assert latest_step(tmp_path) == 1
    assert latest_step(tmp_path / "nothing_here") is None


def test_orphan_staging_dirs_are_removed(tmp_path):
    """A staging dir whose writer is dead, or whose name has no pid, goes
    at the next save; this process's and a live writer's stay."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    tmp_path.mkdir(exist_ok=True)
    orphan = tmp_path / f".tmp-7-{dead.pid}"
    legacy = tmp_path / ".tmp-8"
    mine = tmp_path / f".tmp-9-{os.getpid()}"
    live = tmp_path / ".tmp-10-1"             # pid 1 is alive
    for d in (orphan, legacy, mine, live):
        d.mkdir()
    save(_template(), 11, tmp_path)
    assert not orphan.exists() and not legacy.exists()
    assert mine.exists() and live.exists()
    assert latest_step(tmp_path) == 11


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keeps_the_newest(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    st = _template()
    for step in (1, 2, 3):
        st.window_id = step
        st.controller.demand = torch.full((6,), float(step))
        mgr.save(st, step)
    # the host copy was taken at save time: later in-place updates do not
    # reach the checkpoint
    st.controller.demand.fill_(-1.0)
    assert mgr.latest() == 3
    kept = sorted(d.name for d in tmp_path.iterdir())
    assert kept == ["step_00000002", "step_00000003"]
    out, step = mgr.restore(_template(), device="cpu")
    assert step == 3 and out.window_id == 3
    assert torch.equal(out.controller.demand, torch.full((6,), 3.0))
    assert CheckpointManager(tmp_path / "empty").restore(_template()) == \
        (None, None)


def test_async_save_failure_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    mgr = CheckpointManager(blocker, async_save=True)
    mgr.save(_template(), 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                # raised once


def test_port_resume_is_bitwise(tmp_path, ref_runs):
    """Checkpoint the port's chaos carry at window CUT, restore it in a
    fresh runtime: the rest of the run is the uninterrupted run's."""
    windows, _, _ = ref_runs
    full = _port_runtime().run(windows)
    head = _port_runtime().run(windows, n_windows=CUT)
    save(head["final_state"], CUT, tmp_path)
    st = restore(tmp_path, latest_step(tmp_path), _template(), device="cpu")
    tail = _port_runtime().run(windows, n_windows=len(windows) - CUT,
                               state=st)
    assert head["wan_bytes"] + tail["wan_bytes"] == full["wan_bytes"]
    _assert_resumed(tail, full)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, ref_runs):
    windows, full, head = ref_runs
    ref_save(head["final_state"], CUT, tmp_path)
    st = restore(tmp_path, latest_step(tmp_path), _template(), device="cpu")
    assert st.window_id == CUT
    tail = _port_runtime().run(windows, n_windows=len(windows) - CUT,
                               state=st)
    assert int(head["wan_bytes"]) + tail["wan_bytes"] == full["wan_bytes"]
    _assert_resumed(tail, full)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, ref_runs):
    windows, full, head = ref_runs
    port_head = _port_runtime().run(windows, n_windows=CUT)
    save(port_head["final_state"], CUT, tmp_path)
    st = ref_restore(tmp_path, ref_latest_step(tmp_path),
                     jax.eval_shape(lambda: head["final_state"]))
    tail = RefScanRuntime.from_scenario(
        RefScenario.from_dict(_scenario())).run(
            windows, n_windows=len(windows) - CUT, state=st)
    assert port_head["wan_bytes"] + int(tail["wan_bytes"]) == \
        full["wan_bytes"]
    _assert_resumed(tail, full)
