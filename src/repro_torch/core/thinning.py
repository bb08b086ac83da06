"""Relaxations of the iid assumption (§IV-D, §V-F) — port of
``repro.core.thinning``.

* Thinning: keep every s-th tuple of a stream, s the smallest lag whose
  autocorrelation falls inside the ±1.96/sqrt(N) band (at most
  ``max_lag + 1``).
* m-dependence: inflate the objective's variance by 2 sum_{j<=m} gamma_j
  (eq. 9), floored at a small multiple of sigma^2; convexity is kept (the
  penalty does not depend on n).

The autocovariances and the partial autocorrelations run on the caller's
device (``repro_torch.core.stats``, the reference's op order) and come back
in one read; the band tests, the strides, the thinned window and the
eq.-9 combination are host numpy, the reference's calls.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.registry import IID_MODES
from repro_torch.core import stats as S
from repro_torch.core.types import host_arrays


def significant_lags(x: np.ndarray, n_valid: int, max_lag: int = 8,
                     device=None) -> int:
    """Count of leading PACF lags outside the ±1.96/sqrt(N) band."""
    xt = torch.as_tensor(np.asarray(x, np.float32),
                         device=resolve_device(device))
    p = S.pacf(xt, int(n_valid), max_lag).cpu().numpy()
    band = 1.96 / np.sqrt(max(n_valid, 2))
    sig = 0
    for v in p:
        if abs(v) > band:
            sig += 1
        else:
            break
    return sig


def _stride(x: np.ndarray, n: int, g: np.ndarray, max_lag: int) -> int:
    """The stride from the autocovariances ``g`` of ``x[:n]``."""
    band = 1.96 / np.sqrt(max(n, 2))
    var = float(np.var(x[:n])) + 1e-12
    acf = g / var
    for lag, v in enumerate(acf, start=1):
        if abs(v) <= band:
            return lag
    return max_lag + 1


def _prefix_autocovariances(values: np.ndarray, counts: np.ndarray,
                            max_lag: int, device) -> np.ndarray:
    """(k, max_lag) f32: the autocovariances of each stream's valid
    prefix ``values[i, :counts[i]]``, taken as a stream of its own length
    (one upload; the streams of one count together; one read)."""
    v = torch.as_tensor(np.asarray(values, np.float32),
                        device=resolve_device(device))
    counts = [int(c) for c in counts]
    out = {}
    for n in sorted(set(counts)):
        rows = [i for i, c in enumerate(counts) if c == n]
        out[str(n)] = S.autocovariance(v[rows, :n], n, max_lag)
    host = host_arrays(out)
    g = np.zeros((len(counts), max_lag), np.float32)
    for n in set(counts):
        g[[i for i, c in enumerate(counts) if c == n]] = host[str(n)]
    return g


def thinning_stride(x: np.ndarray, n_valid: int, max_lag: int = 8,
                    device=None) -> int:
    """Smallest stride s with |ACF(s)| inside the ±1.96/sqrt(N) band:
    subsampling at that stride leaves about uncorrelated tuples
    (Markov-chain thinning, §IV-D).  At most ``max_lag + 1``."""
    n = int(n_valid)
    g = _prefix_autocovariances(np.asarray(x)[None], [n], max_lag, device)
    return _stride(np.asarray(x), n, g[0], max_lag)


def thin_window(values: np.ndarray, counts: np.ndarray, max_lag: int = 8,
                device=None):
    """Per-stream stride subsampling.  Returns (values', counts',
    strides)."""
    k, n_max = values.shape
    g = _prefix_autocovariances(values, counts, max_lag, device)
    out = np.zeros_like(values)
    new_counts = np.zeros_like(counts)
    strides = np.ones(k, np.int64)
    for i in range(k):
        n = int(counts[i])
        s = _stride(values[i], n, g[i], max_lag)
        kept = values[i, :n][::s]
        out[i, : len(kept)] = kept
        new_counts[i] = len(kept)
        strides[i] = s
    return out, new_counts, strides


def _identity_window(values: np.ndarray, counts: np.ndarray):
    """The iid assumption taken at face value: the window passes through."""
    return values, counts, None


def m_dependence_terms(v: torch.Tensor, c: torch.Tensor, m: int):
    """Eq. 9's device part for a (k, N) window: the unbiased variance and
    gamma_1..gamma_m of each stream, (k,) and (k, m)."""
    _, var, _, _ = S.masked_central_moments(v, c)
    return var, S.autocovariance(v, c, m)


def m_dependence_from_terms(var: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Eq. 9 on the host: sigma_eff^2 = sigma^2 + 2 sum_j gamma_j, floored
    at 0.05 sigma^2 + 1e-12 (the autocovariance sum can be negative)."""
    out = np.zeros(len(var))
    for i in range(len(var)):
        out[i] = max(float(var[i]) + 2.0 * float(g[i].sum()),
                     0.05 * float(var[i]) + 1e-12)
    return out


def m_dependence_sigma2(values: np.ndarray, counts: np.ndarray, m: int,
                        device=None) -> np.ndarray:
    """Effective per-stream variance for the objective under m-dependence
    (eq. 9), (k,) f64."""
    dev = resolve_device(device)
    var, g = m_dependence_terms(
        torch.as_tensor(np.asarray(values, np.float32), device=dev),
        torch.as_tensor(np.asarray(counts, np.int32), device=dev), m)
    host = host_arrays({"var": var, "g": g})
    return m_dependence_from_terms(host["var"], host["g"])


# PlannerConfig.iid_mode resolves through this registry ("iid" is the
# historical alias of "none").  The entries' signatures differ by mode, so
# the planner dispatches on the name; the registry validates the name.
IID_MODES.register("none", _identity_window, aliases=("iid",))
IID_MODES.register("thinning", thin_window)
IID_MODES.register("m_dependence", m_dependence_sigma2)
