"""PyTorch / CUDA port of the DeFTA reproduction (the JAX package
``repro`` is the reference it is held against).

This package imports ``torch`` and numpy only, never ``jax`` and no module
of ``repro``. Its entry points run on the card unless the caller passes
``device="cpu"``; the gossip-mix kernels are CUDA C++ for ``sm_90a``
(``repro_torch.kernels``), built at first use.
"""
from repro_torch.device import resolve_device, to_numpy, to_torch

__all__ = ["resolve_device", "to_numpy", "to_torch"]
