"""Granite-20B-Code — llama-arch code model with MQA [arXiv:2405.04324]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # MQA (GQA kv=1)
    d_ff=24_576,
    vocab_size=49_152,
    mlp_gelu=True,           # gpt-bigcode 2-matrix MLP (matches 20B count)
)
