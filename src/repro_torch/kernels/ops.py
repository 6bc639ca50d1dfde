"""Wrappers of the three gossip-mix kernels.

Each wrapper checks device, dtype, shape and contiguity, then runs the
plain PyTorch version (``ref``) when the tensors lie on the CPU and the
CUDA kernel (``csrc/``, built by ``build``) when they lie on the card. On
the card it launches the kernel or raises; it never falls back. Every
output is a fresh float32 [W, F] tensor. ``LAUNCHES[name]`` counts kernel
launches (never plain-version calls), so a run can show that it went
through the kernels.

The padded-CSR ``idx`` must lie in [0, W) (``core.gossip.sparse_weights``
builds it so). It is not checked on the card, where a check would cost a
device synchronize per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {name: 0 for name in build.KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, t, dtypes, shape):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on any
    other device."""
    kinds = {t.device for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, kinds))}")
    dev = kinds.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _launch(name, out, *args):
    """Call the kernel's C entry on the tensors' device and its current
    stream; raise on a refused launch, count it otherwise."""
    fn = build.load(name)
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def gossip_mix(P, w):
    """Dense mix ``P @ w``: P [W, W] f32; w [W, F] f32, bf16 or int8."""
    n, f = w.shape
    _check("P", P, (torch.float32,), (n, n))
    _check("w", w, tuple(_DTYPE_CODE), (n, f))
    if not _on_card(P, w):
        return ref.gossip_mix_ref(P, w)
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix", out, P.data_ptr(), w.data_ptr(),
                   out.data_ptr(), n, f, _DTYPE_CODE[w.dtype])


def gossip_mix_sparse(idx, val, w):
    """Padded-CSR mix: idx [W, K] int32; val [W, K] f32 (0 on pad slots);
    w [W, F] f32 or bf16. out[i] = sum_k val[i, k] * w[idx[i, k]]."""
    n, f = w.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("w", w, (torch.float32, torch.bfloat16), (n, f))
    if not _on_card(idx, val, w):
        return ref.gossip_mix_sparse_ref(idx, val, w)
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix_sparse", out, idx.data_ptr(), val.data_ptr(),
                   w.data_ptr(), out.data_ptr(), n, k, f,
                   _DTYPE_CODE[w.dtype])


def gossip_mix_quant(idx, val, scale, q):
    """Fused int8 dequantize -> padded-CSR mix: idx [W, K] int32; val
    [W, K] f32; scale [W] f32; q [W, F] int8.
    out[i] = sum_k val[i, k] * scale[idx[i, k]] * q[idx[i, k]]."""
    n, f = q.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("scale", scale, (torch.float32,), (n,))
    _check("q", q, (torch.int8,), (n, f))
    if not _on_card(idx, val, scale, q):
        return ref.gossip_mix_quant_ref(idx, val, scale, q)
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix_quant", out, idx.data_ptr(), val.data_ptr(),
                   scale.data_ptr(), q.data_ptr(), out.data_ptr(), n, k, f)
