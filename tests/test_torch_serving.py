"""The port's ``ServeEngine`` against the reference's, on the CPU.

``examples/serve_lm.py``'s six requests on gemma3 smoke with the
reference's ``init_params(PRNGKey(0))`` weights, in f32: every generated
token must equal the reference engine's, and so must the order in which
requests finish.  Then the scheduling on its own: a new batch is admitted
only when every slot is empty, eos evicts a request, and the requests still
running at ``max_steps`` are drained as done.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.__main__ import PROMPTS

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, MAX_SEQ = 4, 96


@functools.cache
def _setup():
    rc = dataclasses.replace(ref_config("gemma3-12b", smoke=True),
                             dtype="float32")
    pc = dataclasses.replace(get_config("gemma3-12b", smoke=True),
                             dtype="float32")
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rc))
    return rc, pc, tree, params_from_jax(tree, pc)


def _serve(requests, max_steps=512, **kw):
    """Run the same requests (rid, prompt, max_new_tokens, eos) through
    both engines; returns both finished lists and both engines."""
    rc, pc, tree, params = _setup()
    ref = RefEngine(tree, rc, batch_slots=SLOTS, max_seq=MAX_SEQ)
    port = ServeEngine(params, pc, batch_slots=SLOTS, max_seq=MAX_SEQ,
                       device="cpu", **kw)
    for rid, prompt, n, eos in requests:
        ref.submit(RefRequest(rid=rid, prompt=prompt, max_new_tokens=n,
                              eos=eos))
        port.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n,
                            eos=eos))
    return ref.run(max_steps), port.run(max_steps), ref, port


def _record(done):
    return [(r.rid, r.generated, r.done) for r in done]


@functools.cache
def _example_runs():
    return _serve([(i, p, 12, None) for i, p in enumerate(PROMPTS)])


def test_example_requests_give_the_reference_tokens():
    ref_done, port_done, ref, port = _example_runs()
    assert len(port_done) == 6
    assert sum(len(r.generated) for r in port_done) == 72
    assert _record(port_done) == _record(ref_done)
    assert port.steps == ref.steps


def test_a_batch_is_admitted_only_when_every_slot_is_empty():
    """Request 0 stops after 2 tokens, but request 4 waits until the whole
    first batch is done (the longest at 8 tokens: 7 decode steps)."""
    rc, pc, _, params = _setup()
    engine = ServeEngine(params, pc, batch_slots=SLOTS, max_seq=MAX_SEQ,
                         device="cpu")
    budgets = [2, 8, 5, 5, 3, 3]
    for i, (p, n) in enumerate(zip(PROMPTS, budgets)):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    admitted = []
    prefill = engine._batch_prefill

    def spy(reqs):
        admitted.append((engine.steps, [r.rid for r in reqs]))
        return prefill(reqs)
    engine._batch_prefill = spy
    done = engine.run()
    # the second batch: requests 4 and 5, its empty slots mirroring 5
    assert admitted == [(0, [0, 1, 2, 3]), (7, [4, 5, 5, 5])]
    assert [r.rid for r in done] == [0, 2, 3, 1, 4, 5]
    assert [len(r.generated) for r in sorted(done, key=lambda r: r.rid)] \
        == budgets
    ref_done, port_done, _, _ = _serve(
        [(i, p, n, None) for i, (p, n) in enumerate(zip(PROMPTS, budgets))])
    assert _record(port_done) == _record(ref_done)


def test_eos_evicts_a_request():
    """The eos is a token of request 1 in the example run, the first new
    one from its third on: it stops there, in both engines; the others run
    to their budget."""
    _, base, _, _ = _example_runs()
    gen = {r.rid: r for r in base}[1].generated
    k = next(i for i in range(2, len(gen)) if gen[i] not in gen[:i])
    eos = gen[k]
    reqs = [(i, p, 12, eos if i == 1 else None)
            for i, p in enumerate(PROMPTS)]
    ref_done, port_done, _, _ = _serve(reqs)
    assert _record(port_done) == _record(ref_done)
    got = {r.rid: r.generated for r in port_done}
    assert got[1] == gen[:k + 1]
    assert all(len(got[i]) == 12 for i in got if i != 1)


def test_max_steps_drains_the_running_requests():
    ref_done, port_done, ref, port = _serve(
        [(i, p, 12, None) for i, p in enumerate(PROMPTS)], max_steps=3)
    assert _record(port_done) == _record(ref_done)
    assert [len(r.generated) for r in port_done] == [4] * 4
    assert all(r.done for r in port_done)
    assert [r.rid for r in port.queue] == [r.rid for r in ref.queue] == [4, 5]
    assert port.slots == [None] * SLOTS


def test_bf16_engine_serves_the_same_tokens_on_either_route():
    """bf16 (the configs' type): on the CPU both routes take the plain
    attention, so ``use_kernel`` changes no token."""
    cfg = get_config("gemma3-12b", smoke=True)
    runs = []
    for use_kernel in (True, False):
        engine = ServeEngine(None, cfg, batch_slots=2, max_seq=32,
                             device="cpu", use_kernel=use_kernel, seed=3)
        for i, p in enumerate(PROMPTS[:3]):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        runs.append(_record(engine.run()))
    assert runs[0] == runs[1]
    assert [len(g) for _, g, _ in runs[0]] == [5, 5, 5]
    assert all(0 <= t < cfg.vocab for _, g, _ in runs[0] for t in g)


@pytest.mark.parametrize("arch,needs", [
    ("qwen2-vl-2b", "patch_embeds"), ("whisper-large-v3", "encoder_embeds")])
def test_engine_refuses_the_stub_families(arch, needs):
    """The engine passes tokens only, as the reference's does: the
    reference's engine fails in its first prefill on the stub's missing
    input, and the port's refuses such a config when it is built, naming
    the input and the factories that serve it."""
    rc = ref_config(arch, smoke=True)
    ref = RefEngine(jax.tree.map(np.asarray, ref_init_params(
        jax.random.PRNGKey(0), rc)), rc, batch_slots=2, max_seq=16)
    ref.submit(RefRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(KeyError, match=needs):
        ref.run()
    with pytest.raises(ValueError, match=f"{needs}.*make_prefill"):
        ServeEngine(None, get_config(arch, smoke=True), device="cpu")


def test_engine_defaults_to_the_gpu():
    cfg = get_config("gemma3-12b", smoke=True)
    if torch.cuda.is_available():
        assert ServeEngine(None, cfg).model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(None, cfg)


def test_the_command_serves_the_example_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving", "--smoke", "--device",
         "cpu"], capture_output=True, text=True, timeout=120, check=True,
        cwd=ROOT, env=env)
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("served 6 requests, 72 tokens in ")
    assert "on cpu, batch=4)" in lines[0]
    assert [ln.split(" prompt=")[0].strip() for ln in lines[1:]] == \
        [f"req{i}" for i in range(6)]
