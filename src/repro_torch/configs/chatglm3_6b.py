"""chatglm3-6b [dense]: 28L d=4096 32H (kv 2) ff=13696 vocab=65024.

2d RoPE (rotary on half of head_dim), GQA(2).  [arXiv:2406.12793]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
    vocab=65024, head_dim=128, pattern=("attn",), rope="rope2d",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="chatglm3-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, pattern=("attn",), rope="rope2d",
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
