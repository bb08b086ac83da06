"""The committed port-owned reports of the seven single-edge event
goldens, each run with the reference's IPM under ``x64_workaround``: byte
for byte what the live reference gives now.

A file of its own: regenerating every golden with the live reference is
one of the longest tests of the port, and under ``--dist loadfile`` each
file runs on one worker, so the three groups run side by side.
"""
from test_torch_sweep import SINGLE_EVENT_GOLDENS, check_live_reference


def test_committed_reports_are_the_live_reference(tmp_path):
    check_live_reference(tmp_path, SINGLE_EVENT_GOLDENS)
