"""Kimi K2 — trillion-parameter MoE, 32B active [arXiv:2501.kimi2].

DeepSeek-V3-style fine-grained MoE: 384 routed experts, top-8, 1 shared
expert, dense first layer. d_ff=2048 is the per-expert hidden width.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,          # GQA
    d_ff=18_432,             # dense layers' FFN width (first_dense layer)
    vocab_size=163_840,
    head_dim=112,            # 7168 / 64
    moe=MoEConfig(num_experts=384, top_k=8, num_shared_experts=1,
                  d_expert=2048),
    first_dense=1,
    rope_theta=50_000.0,
)
