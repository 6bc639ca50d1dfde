"""``moe_route_slots``'s share of its roofline: every call over the pod's
batch x S tokens' float32 router logits, at the grouped dispatch's
capacity."""
from bench.metrics._kernel import share
from bench.reference.deepseek_moe import capacity
from bench.roofline import route_slots_cost


def read(record):
    cfg, t = record["config"], record["traffic"]
    m = cfg["moe"]
    tokens = t["batch_per_pod"] * t["seq_len"]
    cap = capacity(tokens, m["num_experts"], m["top_k"])
    return share(record, "route_slots_kernel", "moe_route_slots",
                 route_slots_cost(tokens, m["num_experts"], m["top_k"], cap,
                                  4))
