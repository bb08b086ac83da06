"""gemma3-12b [dense]: 48L d=3840 16H (kv 8) ff=15360 vocab=262144.

5:1 local:global sliding-window pattern (window 1024), RoPE, soft-capped
logits, scaled embeddings.  [hf:google/gemma-3; assignment spec verbatim]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
    vocab=262144, head_dim=240,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, rope="rope", rope_theta=1_000_000.0,
    logit_softcap=30.0, scale_embed=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=16, rope="rope", logit_softcap=30.0, scale_embed=True,
    tie_embeddings=True,
)

# long_500k runs: 5/6 layers are O(window) sliding-window; the global layers
# at decode are linear-in-cache reads (sub-quadratic decode overall).
SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "ok",
}
