"""Mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,                  # no separate FFN; mamba block only
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
)
