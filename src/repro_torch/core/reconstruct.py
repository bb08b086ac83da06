"""Cloud-side window reconstruction (§III-A) — host numpy, copied from
``repro.core.reconstruct`` for the payload replay.

The cloud imputes stream i by evaluating E[X_i | X_{p_i}] on the front of
the predictor's real samples — zero extra WAN bytes for imputed points.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import CompactModel, EdgePayload


def _eval_model_np(model: CompactModel, i: int, xp: np.ndarray) -> np.ndarray:
    c = np.asarray(model.coeffs)[i]
    loc = float(np.asarray(model.loc)[i])
    scale = float(np.asarray(model.scale)[i])
    u = (xp - loc) / scale
    return c[0] + c[1] * u + c[2] * u**2 + c[3] * u**3


def _eval_multi_np(model: dict, i: int, xp: np.ndarray, xq: np.ndarray):
    c = np.asarray(model["coeffs"])[i]
    loc = np.asarray(model["loc"])[i]
    sc = np.asarray(model["scale"])[i]
    u = (xp - loc[0]) / sc[0]
    v = (xq - loc[1]) / sc[1]
    return c[0] + c[1] * u + c[2] * v + c[3] * u * v


def reconstruct_window(payload: EdgePayload) -> list:
    """Per-stream reconstructed sample arrays (real ++ imputed)."""
    k = len(payload.n_real)
    pred = np.asarray(payload.predictor)
    multi = pred.ndim == 2
    out = []
    for i in range(k):
        real = payload.real_values[i]
        ns = int(payload.n_imputed[i])
        if ns <= 0:
            out.append(real)
            continue
        if multi:
            xp = payload.real_values[int(pred[i, 0])]
            xq = payload.real_values[int(pred[i, 1])]
            ns = min(ns, len(xp), len(xq))
        else:
            xp = payload.real_values[int(pred[i])]
            ns = min(ns, len(xp))           # constraint 1d, belt and braces
        if ns == 0:
            out.append(real)
            continue
        if payload.mean_imputation or payload.model is None:
            mu = float(payload.stats_digest["mean"][i])
            imputed = np.full((ns,), mu, np.float32)
        elif multi:
            imputed = _eval_multi_np(payload.model, i, xp[:ns],
                                     xq[:ns]).astype(np.float32)
        else:
            imputed = _eval_model_np(payload.model, i,
                                     xp[:ns]).astype(np.float32)
        out.append(np.concatenate([real, imputed]))
    return out
