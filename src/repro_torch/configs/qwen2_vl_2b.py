"""qwen2-vl-2b [vlm]: 28L d=1536 12H (kv 2) ff=8960 vocab=151936.

M-RoPE; dynamic-resolution vision frontend STUBBED — input_specs provides
precomputed patch embeddings + 3d positions.  [arXiv:2409.12191]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151936, head_dim=128, pattern=("attn",), rope="mrope",
    rope_theta=1_000_000.0, frontend="vision_stub", n_patches=256,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, pattern=("attn",), rope="mrope",
    frontend="vision_stub", n_patches=16,
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:pure full attention (no sub-quadratic variant)",
}
