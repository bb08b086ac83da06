"""Hand-written CUDA kernels for Hopper, each beside its plain version.

stream_stats    — power sums S1..S4 and cross products: the per-site Gram
                  blocks of a whole fleet in one pass
                  (``fleet_window_moments_xxt``, replaces
                  ``stream_stats_fleet_pallas``) and the full k×k X·Xᵀ of
                  one window (``window_moments_xxt``, replaces
                  ``stream_stats_pallas``).
polyfit         — Vandermonde power sums Σuᵐ, Σy·uᵐ for the compact-model
                  fits (``vandermonde_moments``, replaces
                  ``polyfit_pallas``).
flash_attention — online-softmax attention forward, causal/sliding-window,
                  GQA (``flash_attention``, replaces
                  ``flash_attention_pallas``): bf16 on the tensor cores
                  (``csrc/flash_attention_sm90.cu``), f32 on the CUDA
                  cores (``csrc/flash_attention.cu``).

Sources live in ``csrc/`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`); nothing is built at import time.
"""
from repro_torch.kernels.stream_stats.ops import (fleet_window_moments_xxt,
                                                  window_moments_xxt)
from repro_torch.kernels.polyfit.ops import vandermonde_moments
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["window_moments_xxt", "fleet_window_moments_xxt",
           "vandermonde_moments", "flash_attention"]
