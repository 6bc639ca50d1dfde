"""The plain reference's shared parts: norms, the loss, the matmul at a
stated precision, Adam, and three steps of one pod's training.

Plain PyTorch only: nothing of the program under test is imported, and
nothing it made is read. Every quantity is computed in float32 with TF32
off (``fp32_matmul``), unless a lower precision is asked for: the control
(``precision="fp8"``) rounds both operands of every product to float8
e4m3 with a per-tensor scale, passing the float32 gradient straight
through.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0        # the largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_matmul():
    """TF32 off for products while the reference runs, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Precision:
    """Where the products are computed: ``fp32`` exactly, or ``fp8``
    (both operands rounded to e4m3 at a per-tensor scale)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def q(self, a):
        if self.name == "fp32":
            return a
        scale = a.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        low = (a.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return a + (low - a.detach())

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, *ts):
        return torch.einsum(eq, *(self.q(t) for t in ts))


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, wi, wg, wo, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def next_token_loss(logits, tokens):
    """Mean cross-entropy of position t's logits against token t + 1."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           tokens[:, 1:].reshape(-1))


class Adam:
    """Adam with bias correction, moments in float32; each parameter is
    stored back in ``store_dtype`` after its update (round to nearest
    even), as the configuration keeps its weights."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8,
                 store_dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.store_dtype = store_dtype

    def init(self, params):
        return {k: (torch.zeros_like(p), torch.zeros_like(p))
                for k, p in params.items()}

    def step(self, params, grads, state, t: int):
        out, new_state = {}, {}
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        for k, p in params.items():
            m, v = state[k]
            g = grads[k]
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            out[k] = (p - self.lr * upd).to(self.store_dtype).float()
            new_state[k] = (m, v)
        return out, new_state


def train_pod(model, params, batches, opt: Adam):
    """Three (or ``len(batches)``) steps of one pod from ``params`` (a flat
    dict of float32 leaves) on its token batches [B, S]. Returns {"loss":
    [per step], "grad_norm": {leaf: the first step's gradient norm},
    "change_norm": {leaf: |params after the steps - params|}}."""
    start = params
    state = opt.init(params)
    losses, grad_norm = [], None
    for t, tokens in enumerate(batches, start=1):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = model.loss(leaves, tokens)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        if grad_norm is None:
            grad_norm = {k: float(g.norm()) for k, g in grads.items()}
        params, state = opt.step(params, grads, state, t)
        del leaves, grads, loss
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}
