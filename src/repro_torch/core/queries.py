"""Cloud-side aggregate queries and NRMSE (§V-A4) — host numpy, copied
from ``repro.core.queries`` for the payload replay."""
from __future__ import annotations

import numpy as np

from repro_torch.api.registry import QUERIES


@QUERIES.register("AVG")
def avg(x: np.ndarray) -> float:
    return float(np.mean(x)) if len(x) else float("nan")


@QUERIES.register("VAR")
def var(x: np.ndarray) -> float:
    return float(np.var(x, ddof=1)) if len(x) > 1 else float("nan")


@QUERIES.register("MIN")
def vmin(x: np.ndarray) -> float:
    return float(np.min(x)) if len(x) else float("nan")


@QUERIES.register("MAX")
def vmax(x: np.ndarray) -> float:
    return float(np.max(x)) if len(x) else float("nan")


@QUERIES.register("MEDIAN")
def median(x: np.ndarray) -> float:
    return float(np.median(x)) if len(x) else float("nan")


def quantile(x: np.ndarray, q: float) -> float:
    return float(np.quantile(x, q)) if len(x) else float("nan")


def nrmse(estimates: np.ndarray, truth: np.ndarray) -> float:
    """eq. 10 for one stream: RMSE over windows / mean |true aggregate|."""
    est = np.asarray(estimates, np.float64)
    tru = np.asarray(truth, np.float64)
    ok = np.isfinite(est) & np.isfinite(tru)
    if not ok.any():
        return float("nan")
    rmse = np.sqrt(np.mean((est[ok] - tru[ok]) ** 2))
    denom = max(abs(np.mean(tru[ok])), 1e-9)
    return float(rmse / denom)


def nrmse_table(estimates: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """(k, T) x (k, T) -> (k,) per-stream NRMSE."""
    return np.asarray([nrmse(estimates[i], truth[i])
                       for i in range(len(truth))])
