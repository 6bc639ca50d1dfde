"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,          # GQA
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
