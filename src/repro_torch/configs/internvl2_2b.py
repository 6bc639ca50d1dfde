"""InternVL2-2B — InternViT-300M + InternLM2-1.8B backbone [arXiv:2404.16821].

The vision tower + MLP projector are STUBBED per the assignment carve-out:
``input_specs`` supplies ``num_vision_tokens`` precomputed patch embeddings
of width ``d_model``; this config describes the language decoder that
consumes them.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,          # GQA
    d_ff=8192,
    vocab_size=92_553,
    rope_theta=1_000_000.0,  # InternLM2 long-context rope base
    num_vision_tokens=256,   # 448px / 14 patch / pixel-shuffle 0.5 -> 256
)
