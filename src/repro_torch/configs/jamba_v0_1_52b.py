"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

Every 8-layer period has 1 attention layer (offset 4); every second layer
uses a 16-expert top-2 MoE FFN. SSM blocks use our Mamba2/SSD substrate
(Jamba v0.1 ships Mamba-1; the SSD formulation is the TPU-native chunked
equivalent — see DESIGN.md hardware-adaptation notes).
"""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA (attention layers only)
    d_ff=14_336,
    vocab_size=65_536,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14_336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    moe_offset=1,
)
