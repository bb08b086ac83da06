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

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

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


def test_every_module_of_the_port_is_imported_here():
    """The walk below covers the modules the port's later slices add."""
    mods = _port_modules()
    for m in ("repro_torch.core.thinning", "repro_torch.core.samplers",
              "repro_torch.planning.engine", "repro_torch.models.transformer",
              "repro_torch.serving.engine", "repro_torch.launch",
              "repro_torch.launch.train", "repro_torch.optim",
              "repro_torch.optim.edge_exchange",
              "repro_torch.data.lm_data", "repro_torch.launch.mesh",
              "repro_torch.parallel.sharding",
              "repro_torch.parallel.collectives"):
        assert m in mods


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
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.sweep", "repro_torch.sweep.runner",
            "repro_torch.sweep.__main__", "repro_torch.adaptive",
            "repro_torch.adaptive.policy", "repro_torch.chaos",
            "repro_torch.chaos.spec", "repro_torch.chaos.carry",
            "repro_torch.chaos.metrics", "repro_torch.ckpt",
            "repro_torch.ckpt.checkpoint", "repro_torch.streaming",
            "repro_torch.streaming.events", "repro_torch.streaming.runtime",
            "repro_torch.fleet.controller", "repro_torch.core.samplers",
            "repro_torch.core.solver", "repro_torch.core.planner",
            "repro_torch.planning.engine", "repro_torch.models",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.convert",
            "repro_torch.configs", "repro_torch.configs.gemma3_12b",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.serving", "repro_torch.serving.engine",
            "repro_torch.serving.__main__", "repro_torch.launch",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.__main__", "repro_torch.optim",
            "repro_torch.optim.adamw",
            "repro_torch.data.lm_data", "repro_torch.launch.mesh",
            "repro_torch.parallel.collectives"} <= set(res["mods"])
    assert res["bad"] == []
    assert res["libs"] == [] and res["built"] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PORT.rglob("*.py"), ROOT / "chip_smoke.py",
        *(ROOT / "scripts" / f"{name}_times.py"
          for name in ("fleet_kernel", "flash_f32", "window_stats",
                       "main_path", "sharded"))]))
def test_no_jax_or_repro_import_lines(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_the_x64_workaround_stays_out_of_the_port():
    """The reference's IPM needs ``jax.experimental.enable_x64`` on JAX
    0.9; only the tests and the reference-report script supply it."""
    paths = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "tests" / "conftest.py"]
    assert not [p for p in paths if "enable_x64" in p.read_text()]


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
    one = ScenarioConfig.from_dict(json.loads(
        (ROOT / "tests" / "goldens" / "scenarios"
         / "single_event_cubic.json").read_text())["scenario"])
    if torch.cuda.is_available():
        assert Experiment.from_scenario(one).runtime.edge.device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Experiment.from_scenario(one)
    assert Experiment.from_scenario(one, device="cpu").runtime.edge \
        .device.type == "cpu"


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
