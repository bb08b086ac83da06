"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv 16 = MHA) ff=1408/expert
vocab=102400, 2 shared + 64 routed experts top-6 (fine-grained).
[arXiv:2401.06066]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=0,
    vocab=102400, head_dim=128, pattern=("attn",), rope="rope",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=1408),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=0,
    vocab=512, head_dim=16, pattern=("attn",), rope="rope",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0,
                  n_shared=1, d_ff_shared=32),
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
