"""yi-9b [dense]: 48L d=4096 32H (kv 4) ff=11008 vocab=64000.

llama-style GQA.  [arXiv:2403.04652]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-9b",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008,
    vocab=64000, head_dim=128, pattern=("attn",), rope="rope",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="yi-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=96,
    vocab=512, head_dim=16, pattern=("attn",), rope="rope",
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
