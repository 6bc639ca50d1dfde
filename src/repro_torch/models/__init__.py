"""The model zoo (dense, moe, ssm, hybrid, encoder-decoder and vlm
families), for training, prefill and decode: layers, attention (the flash
kernels; the reference's blocked schedule as the plain version above S =
2,048), MoE (the router and route-and-slot kernels, expert parallelism),
the Mamba2 mixer (the SSD chunk kernel), blocks and the causal LM."""
from repro_torch.models.model import (  # noqa: F401
    abstract_params, decode_step, forward, init_cache, init_params,
    loss_fn, param_axes,
)
