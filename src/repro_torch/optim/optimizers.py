"""Optimizers (port of ``repro.optim.optimizers``): SGD(+momentum), AdamW
and Adafactor as plain functions on nested dicts of tensors, with the
reference's contract (not ``torch.optim``):

    opt = make_optimizer("adam", lr=1e-3)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

``update`` returns fresh tensors (nothing is updated in place), so a
state may be carried, copied or compared like the reference's pytrees.
``step`` is the 0-based step counter, an int or a 0-dim tensor; the bias
corrections compute from it in float32, as the reference's do. Moments
are fp32 whatever the parameter dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def _map(f, *trees):
    """``f`` over the leaves of nested dicts of matching structure."""
    if isinstance(trees[0], dict):
        return {k: _map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def _step_f32(step, like):
    """The step counter + 1 as a float32 0-dim tensor on ``like``'s
    device."""
    return torch.as_tensor(step, device=like.device).float() + 1.0


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
    def init(params):
        if momentum:
            return {"mu": _map(torch.zeros_like, params)}
        return {}

    def update(params, grads, state, step):
        del step
        if weight_decay:
            grads = _map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mu = _map(lambda m, g: momentum * m + g, state["mu"], grads)
            params = _map(lambda p, m: p - lr * m, params, mu)
            return params, {"mu": mu}
        params = _map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
        return params, state

    return Optimizer("sgd", init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    """AdamW. Moments in fp32 regardless of param dtype."""
    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
        return {"m": _map(f32, params), "v": _map(f32, params)}

    def update(params, grads, state, step):
        t = _step_f32(step, _first_leaf(params))
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                 state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                 state["v"], grads)
        mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(
            b1, dtype=torch.float32, device=t.device), t))
        vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(
            b2, dtype=torch.float32, device=t.device), t))

        def upd(p, m_, v_):
            step_ = m_ * mhat_scale / (torch.sqrt(v_ * vhat_scale) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return (p.float() - lr * step_).to(p.dtype)

        params = _map(upd, params, m, v)
        return params, {"m": m, "v": v}

    return Optimizer("adam", init, update)


def adafactor(lr: float, eps: float = 1e-30, decay: float = 0.8):
    """Factored second-moment estimator (Shazeer & Stern): for a matrix
    (or a stack of them) one row and one column vector instead of the
    full second moment."""
    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": _map_leaves(one, params)}

    def update(params, grads, state, step):
        t = _step_f32(step, _first_leaf(params))
        beta = 1.0 - t ** (-decay)

        def upd(p, g, s):
            g = g.float()
            g2 = g.square() + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / vc.mean(dim=-1)[..., None, None].clamp_min(eps))
                u = g * torch.rsqrt(denom + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS <= 1) for stability
            rms = torch.sqrt(u.square().mean() + 1e-12)
            u = u / rms.clamp_min(1.0)
            return (p.float() - lr * u).to(p.dtype), new_s

        out = _zip_leaves(upd, params, grads, state["f"])
        return (_map_leaves(lambda o: o[0], out),
                {"f": _map_leaves(lambda o: o[1], out)})

    return Optimizer("adafactor", init, update)


def _map_leaves(f, tree):
    """``f`` over the leaves of nested dicts (tensors, or the (param,
    state) pairs ``_zip_leaves`` returns)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(f, v) for k, v in tree.items()}
    return f(tree)


def _zip_leaves(f, params, grads, states):
    """``f(p, g, s)`` at each parameter leaf; a state leaf is the dict of
    its factored moments."""
    if isinstance(params, dict):
        return {k: _zip_leaves(f, params[k], grads[k], states[k])
                for k in params}
    return f(params, grads, states)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name!r}")
