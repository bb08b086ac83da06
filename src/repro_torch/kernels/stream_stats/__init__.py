from repro_torch.kernels.stream_stats.ops import (derived_stats,
                                                  fleet_window_moments_xxt,
                                                  window_moments_xxt)

__all__ = ["derived_stats", "fleet_window_moments_xxt", "window_moments_xxt"]
