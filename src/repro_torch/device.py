"""The port's device rule and the tree converters.

Entry points take ``device=None``, which means the card (``"cuda"``). With
no card present that raises: a run lands on the CPU only when the caller
asks for it (``device="cpu"``), as the tests do. There is no silent CPU
fallback.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card. Raises ``RuntimeError`` when the card is asked
    for and absent. On the card float32 matmuls and convolutions run in
    full float32 (cuDNN would otherwise take TF32 for the CNN's conv)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_torch(tree, device):
    """A dict (or list/tuple) tree of array-likes -> the same tree of
    tensors on ``device``. float64 stays float64; callers pass float32."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None:
        return None
    return torch.as_tensor(np.array(tree)).to(device)


def to_numpy(tree):
    """The inverse of ``to_torch``: tensors -> numpy arrays, same tree."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().cpu().numpy()
