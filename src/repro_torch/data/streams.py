"""The fleet data generator, copied from ``repro.data.streams``.

The same numpy code in the same order of random draws, so the same seed
gives bitwise the same windows as the reference.  The single-edge
generators (home, turbine, smartcity, mvn) come with the single-edge scans.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.registry import DATASETS


def _ar1(rng, n, phi, sigma):
    x = np.zeros(n)
    e = rng.normal(0.0, sigma, n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x


def fleet_like(n_sites: int = 16, n_regions: int = 4, k: int = 6,
               n_points: int = 2048, seed: int = 0,
               region_strength=None, region_volatility=None,
               window=None, strength_schedule=None):
    """Regionally-correlated fleet of edge sites.

    Sites are assigned to regions in contiguous blocks; each region has a
    latent signal (diurnal cycle + AR(1) weather) that each site mixes into
    its k streams with weight ``region_strength[r]``:

        x_j = scale_j * (rho * B_site + sqrt(1 - rho^2) * eta_j) + offset_j + noise

    ``region_volatility`` scales each region's stream spread.
    ``strength_schedule`` (drifting correlation) belongs to the adaptive
    subsystem and is not ported yet.

    Returns (values (E, k, T) float32, meta).
    """
    if strength_schedule is not None:
        raise NotImplementedError(
            "fleet_like(strength_schedule=...) is not ported to repro_torch "
            "yet (ROADMAP.md: queue 1, 'Adaptive')")
    rng = np.random.default_rng(seed)
    if region_strength is None:
        region_strength = np.linspace(0.9, 0.15, n_regions)
    region_strength = np.asarray(region_strength, np.float64)
    if region_volatility is None:
        region_volatility = np.ones(n_regions)
    region_volatility = np.asarray(region_volatility, np.float64)
    sites_per = int(np.ceil(n_sites / n_regions))
    regions = np.minimum(np.arange(n_sites) // sites_per, n_regions - 1)

    t = np.arange(n_points)
    signals = [np.sin(2 * np.pi * t / 288.0) + 0.5 * _ar1(rng, n_points, 0.97, 0.2)
               for _ in range(n_regions)]
    out = np.empty((n_sites, k, n_points), np.float32)
    for s in range(n_sites):
        r = int(regions[s])
        rho = float(region_strength[r])
        base = signals[r] + 0.4 * _ar1(rng, n_points, 0.9, 0.3)   # site identity
        base = base / max(np.std(base), 1e-9)
        for j in range(k):
            local = _ar1(rng, n_points, 0.9, 0.4)
            local = local / max(np.std(local), 1e-9)
            offset = rng.uniform(20.0, 80.0)
            scale = rng.uniform(2.0, 6.0) * float(region_volatility[r])
            x = rho * base + np.sqrt(max(1.0 - rho**2, 0.0)) * local
            out[s, j] = (offset + scale * x
                         + rng.normal(0.0, 0.15 * scale, n_points))
    meta = {"name": "fleet", "k": k, "regions": regions,
            "strength": region_strength}
    return out, meta


def fleet_windows(values: np.ndarray, window: int) -> list:
    """Slice a fleet tensor (E, k, T) into tumbling windows (E, k, window)."""
    e, k, total = values.shape
    n_win = total // window
    return [values[:, :, w * window:(w + 1) * window] for w in range(n_win)]


fleet_like.is_fleet_dataset = True
DATASETS.register("fleet", fleet_like)
for _name in ("home", "turbine", "smartcity", "mvn"):
    DATASETS.defer(_name, "queue 1, 'Single-edge scans'")
