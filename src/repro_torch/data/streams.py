"""The data generators, copied from ``repro.data.streams``.

Synthetic stand-ins for the paper's datasets: one edge's (k, T) matrix
(home, turbine, smartcity, mvn), sliced by :func:`windows_from_matrix`,
or a fleet's (E, k, T) tensor, sliced by :func:`fleet_windows`.  The same
numpy code in the same order of random draws, so the same seed gives
bitwise the same windows as the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.registry import DATASETS
from repro_torch.core.types import WindowBatch


def _ar1(rng, n, phi, sigma):
    x = np.zeros(n)
    e = rng.normal(0.0, sigma, n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x


def home_like(n_points: int = 4096, seed: int = 0):
    """Home dataset stand-in: temperature from 3 Massachusetts homes.

    Matched properties: k=3, strong mutual correlation (pairwise ~0.8-0.9),
    shared diurnal cycle + per-home AR(1) drift + sensor measurement noise
    (the noise floor puts NRMSE in the paper's Fig.-3 regime), deg-F scale.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_points)
    diurnal = 8.0 * np.sin(2 * np.pi * t / 288.0)          # 5-min samples, 24h period
    base = 70.0 + diurnal + _ar1(rng, n_points, 0.95, 0.8)
    homes = []
    for i in range(3):
        offset = rng.normal(0.0, 1.5)
        local = _ar1(rng, n_points, 0.8, 0.6)
        noise = rng.normal(0.0, 2.0, n_points)             # sensor noise
        homes.append(base + offset + local + noise)
    vals = np.stack(homes).astype(np.float32)
    return vals, {"name": "home", "k": 3}


def turbine_like(n_points: int = 4096, seed: int = 0, k: int = 8):
    """Turbine dataset stand-in (ENGIE wind farm sensor suite).

    Matched properties (§V-C): heterogeneous sensors — wind speed, power
    (tightly coupled to wind via a cubic-ish power curve, rho ~0.9), rotor
    speed (rho ~0.9 with wind), nacelle/ambient temperatures (rho ~0.3-0.5
    with power through load), and near-independent auxiliary channels
    (rho < 0.05).  Pairwise correlations span <0.05, 0.3-0.5, ~0.9.
    """
    rng = np.random.default_rng(seed)
    wind = 8.0 + _ar1(rng, n_points, 0.97, 0.25) + 1.5 * np.sin(
        2 * np.pi * np.arange(n_points) / 1024.0)
    wind = np.maximum(wind, 0.5)
    power = np.clip(0.4 * wind**3, 0, 2050) + rng.normal(0, 18.0, n_points)
    rotor = 1.8 * wind + rng.normal(0, 0.7, n_points)
    temp_nacelle = 40.0 + 0.006 * power + _ar1(rng, n_points, 0.9, 0.5)
    temp_ambient = 12.0 + 0.002 * power + _ar1(rng, n_points, 0.95, 0.4)
    streams = [wind, power, rotor, temp_nacelle, temp_ambient]
    while len(streams) < k:                      # independent aux channels
        streams.append(50.0 + _ar1(rng, n_points, 0.9, 2.0))
    vals = np.stack(streams[:k]).astype(np.float32)
    return vals, {"name": "turbine", "k": k}


def smartcity_like(n_points: int = 4096, seed: int = 0):
    """Smart-City (Aarhus) stand-in: weather / pollution / parking / traffic.

    Matched properties (§V-D): radically different marginal distributions,
    modest cross-quantity correlations (~0.4-0.6, e.g. parking occupancy vs
    temperature through a shared diurnal driver), noisy, count-valued traffic.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_points)
    diurnal = np.sin(2 * np.pi * t / 288.0)
    activity = np.maximum(diurnal + 0.35 * _ar1(rng, n_points, 0.9, 0.3), -1.0)

    temp = 15.0 + 6.0 * diurnal + _ar1(rng, n_points, 0.97, 0.25)
    humidity = np.clip(65.0 - 8.0 * diurnal + _ar1(rng, n_points, 0.95, 0.8), 5, 100)
    no2 = np.maximum(30.0 + 14.0 * activity + _ar1(rng, n_points, 0.9, 2.5), 0.1)
    parking = np.clip(120.0 + 70.0 * activity + _ar1(rng, n_points, 0.9, 6.0), 0, 250)
    traffic = rng.poisson(np.maximum(20.0 + 15.0 * activity, 0.5)).astype(np.float64)
    vals = np.stack([temp, humidity, no2, parking, traffic]).astype(np.float32)
    return vals, {"name": "smartcity", "k": 5}


def mvn_pair(rho: float, n_points: int = 4096, seed: int = 0,
             mean: float = 30.0, var: float = 16.0):
    """Fig.-8 synthetic: two streams ~ MVN(mean=30, var=16, corr=rho) —
    reproduced exactly as the paper specifies (§V-F 'Correlation Effects')."""
    rng = np.random.default_rng(seed)
    cov = np.array([[var, rho * var], [rho * var, var]])
    vals = rng.multivariate_normal([mean, mean], cov, size=n_points).T
    return vals.astype(np.float32), {"name": f"mvn_rho{rho}", "k": 2}


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

    ``strength_schedule`` makes the regional correlation drift mid-run
    (the adaptive re-planning input): ``[(window_index, rho_per_region),
    ...]``, each entry setting the per-region strength from tuple
    ``window_index * window`` onward (``window`` is required alongside
    it; windows before the first entry keep ``region_strength``).  Every
    random number is drawn in the same order, so a degenerate
    ``[(0, region_strength)]`` gives the unscheduled values bitwise.

    Returns (values (E, k, T) float32, meta).
    """
    rng = np.random.default_rng(seed)
    if region_strength is None:
        region_strength = np.linspace(0.9, 0.15, n_regions)
    region_strength = np.asarray(region_strength, np.float64)
    if region_volatility is None:
        region_volatility = np.ones(n_regions)
    region_volatility = np.asarray(region_volatility, np.float64)
    sites_per = int(np.ceil(n_sites / n_regions))
    regions = np.minimum(np.arange(n_sites) // sites_per, n_regions - 1)

    rho_t = None                       # (n_regions, n_points) when scheduled
    if strength_schedule is not None:
        if window is None:
            raise ValueError("strength_schedule needs the tumbling-window "
                             "length: pass window= alongside it")
        rho_t = np.repeat(region_strength[:, None], n_points, axis=1)
        for wid, rhos in sorted(strength_schedule, key=lambda e: int(e[0])):
            if int(wid) < 0:
                raise ValueError(f"strength_schedule window index must be "
                                 f">= 0, got {wid!r}")
            rhos = np.asarray(rhos, np.float64)
            if rhos.shape != (n_regions,):
                raise ValueError(
                    f"strength_schedule entry at window {wid} has "
                    f"{rhos.shape} strengths; need one per region "
                    f"({n_regions},)")
            rho_t[:, int(wid) * int(window):] = rhos[:, None]

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
            if rho_t is None:
                x = rho * base + np.sqrt(max(1.0 - rho**2, 0.0)) * local
            else:
                rv = rho_t[r]
                x = rv * base + np.sqrt(np.maximum(1.0 - rv**2, 0.0)) * local
            out[s, j] = (offset + scale * x
                         + rng.normal(0.0, 0.15 * scale, n_points))
    meta = {"name": "fleet", "k": k, "regions": regions,
            "strength": region_strength}
    if strength_schedule is not None:
        meta["strength_schedule"] = tuple(
            (int(w), tuple(float(v) for v in np.asarray(r).ravel()))
            for w, r in strength_schedule)
    return out, meta


def fleet_windows(values: np.ndarray, window: int) -> list:
    """Slice a fleet tensor (E, k, T) into tumbling windows (E, k, window)."""
    e, k, total = values.shape
    n_win = total // window
    return [values[:, :, w * window:(w + 1) * window] for w in range(n_win)]


def windows_from_matrix(values: np.ndarray, window: int) -> list:
    """Slice a (k, T) tuple matrix into tumbling windows of ``window``
    tuples."""
    k, total = values.shape
    n_win = total // window
    return [WindowBatch.from_numpy(values[:, w * window:(w + 1) * window],
                                   window_id=w) for w in range(n_win)]


# ``is_fleet_dataset`` marks generators that return an (E, k, T) site
# tensor and take n_sites/n_regions: they need a multi-site topology, and
# the matrix generators cannot be spread over one.
fleet_like.is_fleet_dataset = True
DATASETS.register("home", home_like)
DATASETS.register("turbine", turbine_like)
DATASETS.register("smartcity", smartcity_like)
DATASETS.register("mvn", mvn_pair)
DATASETS.register("fleet", fleet_like)
