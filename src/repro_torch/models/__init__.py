"""The dense decoder families (port of ``repro.models``): configs, layers,
the decoder stack with its ring-cache prefill and decode, and the weight
carry-over from the reference."""
from repro_torch.models.config import (EncoderConfig, ModelConfig, MoEConfig,
                                       SSMConfig)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (Transformer, init_cache,
                                            init_params)

__all__ = ["EncoderConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "Transformer", "init_cache", "init_params", "params_from_jax"]
