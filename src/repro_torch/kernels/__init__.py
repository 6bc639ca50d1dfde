"""The port's kernels (three gossip mixes, flash attention, the MoE router
and route-and-slot, the SSD chunk): CUDA C++ for ``sm_90a`` (``csrc/``,
built by ``build``), their wrappers with launch counters (``ops``) and
their plain PyTorch versions (``ref``)."""
from repro_torch.kernels.ops import (  # noqa: F401
    flash_attention, gossip_mix, gossip_mix_quant, gossip_mix_sparse,
    moe_router_topk, ssd_chunk,
)
