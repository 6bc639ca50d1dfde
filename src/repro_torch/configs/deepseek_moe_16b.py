"""DeepSeekMoE-16B — fine-grained experts: 2 shared + 64 routed top-6
[arXiv:2401.06066]. Dense first layer; d_ff=1408 is per-expert hidden.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,         # MHA
    d_ff=10_944,             # dense layers' FFN width (first layer)
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_expert=1408),
    first_dense=1,
)
