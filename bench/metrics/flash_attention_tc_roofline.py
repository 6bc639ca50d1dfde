"""``flash_attention_tc``'s share of its roofline: every call a causal
self-attention forward at [batch, heads, S, head dim] in bf16."""
from bench.metrics._kernel import share
from bench.roofline import flash_cost


def read(record):
    cfg, t = record["config"], record["traffic"]
    return share(record, "flash_tc_kernel", "flash_attention_tc",
                 flash_cost(t["batch_per_pod"], cfg["num_heads"],
                            t["seq_len"], cfg["head_dim"], 2))
