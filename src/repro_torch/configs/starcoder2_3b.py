"""starcoder2-3b [dense]: 30L d=3072 24H (kv 2) ff=12288 vocab=49152.

GQA + RoPE.  [arXiv:2402.19173]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288,
    vocab=49152, head_dim=128, pattern=("attn",), rope="rope",
    rope_theta=100_000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, pattern=("attn",), rope="rope",
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
