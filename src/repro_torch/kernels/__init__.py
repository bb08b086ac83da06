"""Hand-written CUDA kernels for Hopper, each beside its plain version.

stream_stats — per-site power sums S1..S4 and the diagonal Gram block
               X_e·X_eᵀ for a whole fleet in one pass (replaces the TPU
               kernel ``stream_stats_fleet_pallas``).
polyfit      — Vandermonde power sums Σuᵐ, Σy·uᵐ for the compact-model fits
               (replaces ``polyfit_pallas``).

Sources live in ``csrc/`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`); nothing is built at import time.
"""
