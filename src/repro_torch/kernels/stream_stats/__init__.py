from repro_torch.kernels.stream_stats.ops import fleet_window_moments_xxt

__all__ = ["fleet_window_moments_xxt"]
