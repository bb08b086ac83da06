"""The port stands alone: it imports neither JAX nor the JAX package, and
it runs on the GPU unless the caller asks for the CPU."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.MULTILINE)


def _port_modules() -> list:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_leaves_jax_and_repro_out():
    """Importing every module of the port imports no JAX, no ``repro``
    and no Triton, and builds or loads no kernel library."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules()!r}\n"
        "from repro_torch.kernels import build\n"
        "d = build.build_dir()\n"
        "def ls():\n"
        "    return sorted(p.name for p in d.iterdir()) if d.exists() else []\n"
        "before = ls()\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(json.dumps({'mods': mods, 'bad': bad,\n"
        "                  'libs': sorted(build._LIBS),\n"
        "                  'built': sorted(set(ls()) - set(before))}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["mods"]) >= 30
    assert {"repro_torch.kernels.stream_stats.ops",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref"} <= set(res["mods"])
    assert res["bad"] == []
    assert res["libs"] == [] and res["built"] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PORT.rglob("*.py"), ROOT / "chip_smoke.py",
        ROOT / "scripts" / "fleet_kernel_times.py"]))
def test_no_jax_or_repro_import_lines(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_entry_points_default_to_the_gpu():
    from repro_torch import resolve_device
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    d = json.loads((ROOT / "tests" / "goldens" / "scenarios"
                    / "fleet_scan.json").read_text())["scenario"]
    sc = ScenarioConfig.from_dict(d)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert Experiment.from_scenario(sc).runtime.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Experiment.from_scenario(sc)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert Experiment.from_scenario(sc, device="cpu").runtime.device.type \
        == "cpu"


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
