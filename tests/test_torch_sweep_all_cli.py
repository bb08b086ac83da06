"""The port's golden sweep from the command line, on the CPU: every golden.

A file of its own: under ``--dist loadfile`` a file runs on one
worker, and the sweeps are the longest tests of the port.
"""
import os
import subprocess
import sys

from test_torch_sweep import ALL_NOT_PORTED, PORTED, ROOT, golden_class


def test_sweep_checks_every_ported_golden_on_the_cpu():
    """No filter: the eight scan, six fleet event and seven single-edge
    event goldens (all 21) are checked, each in its own class, and none
    is left not ported."""
    # one intra-op thread: the sweep's tensors are small, and beside the
    # run's other workers more threads only contend for the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "--check", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    for name in PORTED:
        tol = golden_class(name)
        assert any(ln.split() == [name, "ok", f"[{tol}]"] for ln in lines), \
            (name, out.stdout)
    for name, item in ALL_NOT_PORTED.items():
        assert any(ln.split()[:3] == [name, "not", "ported"]
                   and f"'{item}'" in ln for ln in lines), name
    assert "21 scenario(s) checked" in lines[-1]
    assert "0 not ported" in lines[-1]
