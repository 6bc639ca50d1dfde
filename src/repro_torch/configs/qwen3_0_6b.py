"""Qwen3-0.6B — dense GQA with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,          # GQA
    d_ff=3072,
    vocab_size=151_936,
    head_dim=128,            # qwen3 uses head_dim 128 (> d_model/num_heads)
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
