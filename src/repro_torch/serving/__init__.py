"""LM serving (port of ``repro.serving``): ``ServeEngine`` over the dense
decoder families; ``python -m repro_torch.serving`` serves the example's
requests."""
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
