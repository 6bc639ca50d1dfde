"""The paper's own model scale — a 2-layer transformer of the size class
used for Wikitext-2 in DeFTA Table 2 (plus the MLP/CNN models live in
repro.core's simulation substrate, not here).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-small",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=33_278,       # wikitext-2 vocab
    scan_layers=False,
    remat=False,
)
