"""mamba2-780m [ssm]: 48L d=1536, attention-free, vocab=50280,
ssm_state=128 (SSD — state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-780m",
    n_layers=48, d_model=1536, n_heads=1, n_kv=1, d_ff=0,
    vocab=50280, head_dim=64, pattern=("mamba",), rope="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    n_layers=4, d_model=64, n_heads=1, n_kv=1, d_ff=0,
    vocab=512, head_dim=16, pattern=("mamba",), rope="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1, chunk=32),
)

SHAPE_SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "ok",
}
