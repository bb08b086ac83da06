"""The committed port-owned reports of the eight scan goldens, the region
chaos golden's kernel path among them: byte for byte what the live
reference gives now.

A file of its own: regenerating every golden with the live reference is
one of the longest tests of the port, and under ``--dist loadfile`` each
file runs on one worker, so the three groups run side by side.
"""
from test_torch_sweep import SCAN_GOLDENS, check_live_reference


def test_committed_reports_are_the_live_reference(tmp_path):
    check_live_reference(tmp_path, SCAN_GOLDENS)
