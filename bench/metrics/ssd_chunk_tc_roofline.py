"""``ssd_chunk_tc``'s share of its roofline: every call at the cell's
shape, G = batch x chunks, H heads, T the chunk, N the state, P the head
dim."""
from bench.metrics._kernel import share
from bench.roofline import ssd_cost


def read(record):
    cfg, t = record["config"], record["traffic"]
    s = cfg["ssm"]
    q = min(s["chunk_size"], t["seq_len"])
    g = t["batch_per_pod"] * -(-t["seq_len"] // q)
    h = s["expand"] * cfg["d_model"] // s["head_dim"]
    return share(record, "ssd_tc_kernel", "ssd_chunk_tc",
                 ssd_cost(g, h, q, s["d_state"], s["head_dim"]))
