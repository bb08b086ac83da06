"""whisper-large-v3 [audio]: enc-dec, 32L decoder d=1280 20H ff=5120
vocab=51866; conv frontend STUBBED — input_specs provides precomputed
1500-frame encoder embeddings.  [arXiv:2212.04356]
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, head_dim=64, pattern=("attn",), rope="none",
    encoder=EncoderConfig(n_layers=32, seq_len=1500),
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, head_dim=16, pattern=("attn",), rope="none",
    encoder=EncoderConfig(n_layers=2, seq_len=30),
    frontend="audio_stub",
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skip:enc-dec; decoder context is 448 tokens by construction",
}
