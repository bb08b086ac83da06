"""LM serving (port of ``repro.serving``): ``ServeEngine`` over the decoder
families (dense, MoE, Mamba2, the jamba hybrid); ``python -m
repro_torch.serving`` serves the example's requests."""
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
