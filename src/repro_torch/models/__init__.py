"""The model zoo's serving path for the dense and moe families: layers,
attention (flash kernel), MoE (router kernel), blocks and the causal LM."""
from repro_torch.models.model import (  # noqa: F401
    abstract_params, decode_step, forward, init_cache, init_params,
)
