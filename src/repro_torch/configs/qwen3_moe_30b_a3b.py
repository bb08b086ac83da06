"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (kv 4) ff=768/expert
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=0,
    vocab=151936, head_dim=128, pattern=("attn",), rope="rope",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=0,
    vocab=512, head_dim=16, pattern=("attn",), rope="rope",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0),
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
