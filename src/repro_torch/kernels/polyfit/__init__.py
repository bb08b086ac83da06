from repro_torch.kernels.polyfit.ops import (solve_normal_equations,
                                             vandermonde_moments)

__all__ = ["solve_normal_equations", "vandermonde_moments"]
