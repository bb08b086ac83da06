"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (kv 8) ff=24576
vocab=65536, MoE 16 experts top-2; Mamba:attention 7:1 interleave, MoE every
other layer.  [arXiv:2403.19887]
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    rope="none",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=128, n_groups=8),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    rope="none",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, every=2,
                  capacity_factor=8.0),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=2, chunk=32),
)

# hybrid: mamba layers are O(1)-state at decode; the 1/8 attention layers are
# linear-in-cache decode reads => long_500k runs.
SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "ok",
}
