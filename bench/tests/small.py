"""The cells cut to a size a CPU test run can hold, with limits of their
own."""
from __future__ import annotations

import copy

CELLS = ("mamba2-780m.fl4.b2s2048", "deepseek-moe-16b-l2.fl4.b1s4096")

# Limits of the small cells below, set from their CPU readings in bf16
# (the program on seeds 7, 12345678901, 2**31 + 5 against the control in
# float8 e4m3 on the same seeds; see PERF.md).
SMALL_LIMITS = {
    "mamba2-780m.fl4.b2s2048": {
        "loss1_gap": 0.001, "grad_norm_gap": 0.002,
        "change_norm_gap": 0.002, "mix_gap": 0.01, "trust_gap": 1e-4},
    "deepseek-moe-16b-l2.fl4.b1s4096": {
        "loss1_gap": 0.0006, "loss_gap": 0.01, "grad_norm_gap": 0.0016,
        "change_norm_gap": 0.0007, "mix_gap": 0.01, "trust_gap": 1e-4},
}


def small_cell(name: str, dtype: str = "bfloat16") -> dict:
    """The cell ``name`` with every width and length cut to a CPU test's
    size (the same code paths: two layers, the leading dense one and a MoE
    one in DeepSeekMoE), and the limits set for that size."""
    from bench.run import load_cell
    c = copy.deepcopy(load_cell(name))
    cfg = c["config"]
    if cfg["family"] == "ssm":
        cfg.update(num_layers=2, d_model=64, vocab_size=128, dtype=dtype,
                   ssm={"d_state": 16, "d_conv": 4, "expand": 2,
                        "head_dim": 16, "chunk_size": 16})
    else:
        cfg.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                   head_dim=16, d_ff=128, vocab_size=128, dtype=dtype,
                   moe={"num_experts": 8, "top_k": 2,
                        "num_shared_experts": 1, "d_expert": 32,
                        "router_aux_weight": 0.001})
    c["traffic"].update(batch_per_pod=2, seq_len=32)
    c["limits"]["limits"] = dict(SMALL_LIMITS[name])
    return c
