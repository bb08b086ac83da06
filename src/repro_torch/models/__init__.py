"""The decoder families, dense, MoE, Mamba2 and the jamba hybrid (port of
``repro.models``): configs, layers, the decoder stack with its cached
prefill and decode (KV rings, Mamba conv and SSM states) and its training
forward, and the weight and state carry-over from the reference."""
from repro_torch.models.config import (EncoderConfig, ModelConfig, MoEConfig,
                                       SSMConfig)
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        train_state_from_jax,
                                        train_state_template,
                                        train_state_to_jax)
from repro_torch.models.transformer import (Transformer, forward_train,
                                            init_cache, init_params)

__all__ = ["EncoderConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "Transformer", "forward_train", "init_cache", "init_params",
           "params_from_jax", "params_to_jax", "train_state_from_jax",
           "train_state_template", "train_state_to_jax"]
