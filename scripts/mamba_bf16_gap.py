"""How far one Mamba2 mixer in bf16 lands from the same mixer in f32, in
the JAX reference and in the PyTorch port, and where the two packages'
bf16 outputs part, on the CPU.

The reference's SSD takes the cumulative sums of ``dt * A`` and their
differences in the activation type, so in bf16 the decay matrix keeps few
correct bits once those sums grow (ROADMAP queue 3, note n).  This script
runs one mixer of an architecture's config at its full width on a seeded
(1, S) input of N(0, 1) rows, with the reference's ``mamba_init`` weights,
through the reference's jitted ``mamba_apply`` and the port's, each in f32
and in bf16, and prints the RMS of each package's bf16 output minus its
f32 output over the f32 output's RMS, and the two packages' outputs
against each other in each type.

Then it splits the bf16 gap between the two packages (``split``): the
share of output elements that differ, and the largest difference in bf16
steps (2**-7) of the largest |output|, for the port's layer as it is, for
the port's layer with its input and output projections computed by the
reference's jitted einsum on the same operands, and for the port's
``_ssd_chunked`` against the reference's on the same inputs (those the
port's layer hands its SSD).  ``tests/test_torch_lm_mamba.py`` holds
these numbers at full width.  It needs the JAX package, so it runs where
the tests run, never on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mamba_bf16_gap.py \\
        [--arch mamba2-780m] [--seq 512] [--seed 3]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as PL

# the mixer's two projections, as both packages write them
PROJECTIONS = ("bsd,de->bse", "bse,ed->bsd")


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _to_torch(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _setup(arch: str, seq: int, seed: int):
    rc, pc = ref_config(arch), get_config(arch)
    tree = jax.tree.map(np.asarray,
                        RL.mamba_init(jax.random.PRNGKey(seed), rc))
    x = np.random.default_rng(seed).normal(
        size=(1, seq, rc.d_model)).astype(np.float32)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    return rc, pc, tree, params, x


def _gap(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got - want)
    return {"differing": int((d > 0).sum()), "elements": int(d.size),
            "share": float((d > 0).mean()),
            "max_steps": float(d.max() / np.abs(want).max() / 2.0 ** -7)}


@contextlib.contextmanager
def _reference_projections():
    """``torch.einsum`` of the two projections on bf16 operands computed
    by the reference's jitted ``jnp.einsum`` instead."""
    jitted = {eq: jax.jit(lambda a, b, eq=eq: jnp.einsum(eq, a, b))
              for eq in PROJECTIONS}
    orig = torch.einsum

    def einsum(eq, *ops):
        if eq in jitted and ops[0].dtype == torch.bfloat16:
            return _to_torch(jitted[eq](*(_to_jax(t) for t in ops)))
        return orig(eq, *ops)
    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = orig


def split(arch: str = "mamba2-780m", seq: int = 512, seed: int = 3) -> dict:
    """The bf16 gap between the packages' mixers, split as the module
    docstring says: ``{"layer", "layer_reference_projections", "ssd_y",
    "ssd_state"}``, each a ``_gap`` dict."""
    rc, pc, tree, params, x = _setup(arch, seq, seed)
    rcd = dataclasses.replace(rc, dtype="bfloat16")
    pcd = dataclasses.replace(pc, dtype="bfloat16")
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, v: RL.mamba_apply(p, v, rcd)[0])(
        tree, xj).astype(jnp.float32))
    xp = _to_torch(xj)
    ssd_in = []
    ssd = PL._ssd_chunked

    def spy(*a, **kw):
        ssd_in.append(a)
        return ssd(*a, **kw)
    with torch.no_grad():
        layer = PL.mamba_apply(params, xp, pcd)[0].float().numpy()
        PL._ssd_chunked = spy
        try:
            with _reference_projections():
                with_ref = PL.mamba_apply(params, xp, pcd)[0].float().numpy()
        finally:
            PL._ssd_chunked = ssd
        xs, dt, A, Bm, Cm, chunk = ssd_in[0]
        y, state = ssd(xs, dt, A, Bm, Cm, chunk)
    y_ref, state_ref = jax.jit(
        lambda *v: RL._ssd_chunked(*v, chunk))(*map(_to_jax,
                                                   (xs, dt, A, Bm, Cm)))
    return {"layer": _gap(layer, want),
            "layer_reference_projections": _gap(with_ref, want),
            "ssd_y": _gap(y.float().numpy(), np.asarray(
                y_ref.astype(jnp.float32))),
            "ssd_state": _gap(state.float().numpy(), np.asarray(
                state_ref.astype(jnp.float32)))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="scripts/mamba_bf16_gap.py")
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    rc, pc, tree, params, x = _setup(args.arch, args.seq, args.seed)
    out = {}
    for dtype in ("float32", "bfloat16"):
        rcd = dataclasses.replace(rc, dtype=dtype)
        pcd = dataclasses.replace(pc, dtype=dtype)
        xj = jnp.asarray(x).astype(dtype)
        out["reference", dtype] = np.asarray(jax.jit(
            lambda p, v: RL.mamba_apply(p, v, rcd)[0])(tree, xj)
            .astype(jnp.float32))
        with torch.no_grad():
            out["port", dtype] = PL.mamba_apply(params, _to_torch(xj), pcd)[0] \
                .float().numpy()
    rows = {f"{who}_bf16_vs_f32": _rms(out[who, "bfloat16"]
                                       - out[who, "float32"])
            / _rms(out[who, "float32"]) for who in ("reference", "port")}
    for dtype in ("float32", "bfloat16"):
        ref = out["reference", dtype]
        diff = out["port", dtype] - ref
        rows[f"port_vs_reference_{dtype}"] = _rms(diff) / _rms(ref)
        rows[f"elements_differing_{dtype}"] = int((diff != 0).sum())
    rows["elements"] = int(ref.size)
    rows["split"] = split(args.arch, args.seq, args.seed)
    print(f"{args.arch}: one mixer at d {rc.d_model}, (1, {args.seq}), "
          f"chunk {rc.ssm.chunk}, seed {args.seed}")
    for k, v in rows.items():
        if k == "split":
            for part, g in v.items():
                print(f"  bf16 port vs reference, {part}: {g}")
        else:
            print(f"  {k}: {v}")
    return rows


if __name__ == "__main__":
    main()
