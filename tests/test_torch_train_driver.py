"""The port's training driver (``python -m repro_torch.launch.train``) on
the CPU: the reference test's run lowers the loss, a failed run resumed
from its checkpoint ends bitwise where an uninterrupted run ends, and
the exchange and mesh flags run (the sharded runs themselves are held in
``test_torch_lm_mesh_ranks.py``).

The reference's own driver is not run here: on this container its
single-device run fails inside ``mesh_context`` (ROADMAP queue 3, note
c), so the train-step tests hold the port against the reference's
``make_train_step`` directly.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.launch.train import build_argparser, main

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_loss_decreases_single_device():
    """The reference test's flags (``tests/test_train_driver.py``)."""
    losses = main(["--arch", "starcoder2-3b", "--steps", "120",
                   "--batch", "8", "--seq", "48", "--lr", "8e-3",
                   "--log-every", "20", "--device", "cpu"])
    assert len(losses) == 7 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1


def _final(ckpt_dir, step) -> dict:
    with np.load(pathlib.Path(ckpt_dir) / f"step_{step:08d}"
                 / "data.npz") as d:
        return {k: d[k] for k in d.files}


FLAGS = ["--arch", "yi-9b", "--steps", "40", "--batch", "4", "--seq", "32",
         "--ckpt-every", "10", "--log-every", "10", "--device", "cpu"]


def test_failure_injection_and_restart_is_the_uninterrupted_run(tmp_path,
                                                                 capsys):
    whole = {}
    main(FLAGS + ["--ckpt-dir", str(tmp_path / "whole")], stats=whole)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected node failure"):
        main(FLAGS + ["--ckpt-dir", ck, "--fail-at-step", "25"])
    assert "INJECTED FAILURE at step 25" in capsys.readouterr().out
    stats = {}
    resumed = main(FLAGS + ["--ckpt-dir", ck, "--restore"], stats=stats)
    out = capsys.readouterr().out
    assert "restored step 20" in out and "done" in out
    assert stats["step"] == list(range(21, 41))
    # every loss of steps 21..40 bitwise the uninterrupted run's
    assert stats["loss"] == whole["loss"][20:]
    assert resumed == [stats["loss"][i] for i in (0, 9, 19)]
    want, got = _final(tmp_path / "whole", 40), _final(ck, 40)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert int(got[".step"]) == 40


def test_restore_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    flags = ["--steps", "2", "--batch", "2", "--seq", "8", "--log-every",
             "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    fresh = main(flags)
    assert "restored" not in capsys.readouterr().out
    again = main(flags[:1] + ["3"] + flags[2:] + ["--restore"])
    assert "restored step 2" in capsys.readouterr().out
    assert len(fresh) == 2 and len(again) == 1


@pytest.mark.parametrize("flags", [["--host-devices", "2"], ["--pods", "2"],
                                   ["--model-parallel", "2"],
                                   ["--edge-exchange"]],
                         ids=lambda f: f[0])
def test_sharding_flags_raise(flags, capfd):
    """The mesh flags run since LM sharding was ported.  ``--host-devices
    2`` trains on two CPU ranks over gloo, a mesh of two data ranks, each
    on its half of every batch: its first loss is the one-process run's
    within f32 (rtol 1e-5), its second within 1e-3 (after one AdamW step
    taken from two f32 orders of the gradient sums).  ``--model-parallel
    2`` alone raises: one process does not split into two model ranks, as
    the reference's ``make_local_mesh`` asserts.  ``--pods`` and
    ``--edge-exchange`` alone train plain, as the reference's driver does
    (the exchange needs both, ``tests/test_torch_pod_train.py``), bitwise
    the run without them."""
    run = ["--steps", "2", "--batch", "4", "--seq", "8", "--log-every", "1"]
    if flags[0] == "--model-parallel":
        with pytest.raises(ValueError, match="do not split"):
            main(flags + run + ["--device", "cpu"])
        return
    got, plain = {}, {}
    if flags[0] == "--host-devices":
        main(flags + run, stats=got)
        assert "mesh={'data': 2, 'model': 1}" in capfd.readouterr().out
        main(run + ["--device", "cpu"], stats=plain)
        assert got["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(got["loss"][0], plain["loss"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"][1], plain["loss"][1],
                                   rtol=1e-3)
        return
    run += ["--device", "cpu"]
    main(flags + run, stats=got)
    main(run, stats=plain)
    assert "replanned" not in capfd.readouterr().out
    assert "sync_fraction" not in got
    assert got["loss"] == plain["loss"] and all(np.isfinite(got["loss"]))


def test_width_and_depth_overrides():
    from repro_torch.launch.train import config_from_args
    args = build_argparser().parse_args(
        ["--arch", "gemma3-12b", "--d-model", "128", "--n-layers", "13"])
    cfg = config_from_args(args)
    assert (cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_layers) == \
        (128, 128 // cfg.n_heads, 512, 12)


def test_microbatched_driver_run():
    losses = main(["--steps", "3", "--batch", "4", "--seq", "16",
                   "--microbatches", "2", "--log-every", "1",
                   "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_driver_defaults_to_the_gpu():
    if torch.cuda.is_available():
        assert main(["--steps", "1", "--batch", "2", "--seq", "8"])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])
