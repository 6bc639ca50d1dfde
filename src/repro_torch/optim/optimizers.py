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

On a placed tree (``sharding.Placed`` leaves: ``launch.steps.place_state``)
the update runs per block, each on the devices holding it
(``counting.device``). SGD and Adam are elementwise: each state block
updates its region of the parameter's block (a ZeRO-1 moment block, split
further over the data axis, a slice of it; the parameter's block is then
gathered from its slices). Adafactor's factored statistics are not:
vr = mean(g^2, -1) and vc = mean(g^2, -2) over a split dim, vc.mean(-1)
and the update's RMS need sums across the blocks. Each block's row and
column sums are all-reduced into the whole (small) statistics, and the
RMS's sum of squares with them, so the step equals the unsharded one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import counting, sharding
from repro_torch.sharding import Placed


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
        if sharding.is_placed(params):
            return _elementwise_placed(update, params, grads, state, step,
                                       ("mu",) if momentum else ())
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
        if sharding.is_placed(params):
            return _elementwise_placed(update, params, grads, state, step,
                                       ("m", "v"))
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
        if sharding.is_placed(params):
            return _adafactor_placed(params, grads, state, step, lr, eps,
                                     decay)
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


# ---------------------------------------------------------------------------
# Placed trees: the update per block
# ---------------------------------------------------------------------------

def _leaves(tree):
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += _leaves(v)
    else:
        out.append(tree)
    return out


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    return next(it)


def _within(inner, outer):
    """The region ``inner`` relative to ``outer``, or None when ``outer``
    does not hold it (index-tensor dims must be equal)."""
    rel = []
    for a, b in zip(inner, outer):
        if isinstance(a, slice) != isinstance(b, slice):
            return None
        if isinstance(a, slice):
            if not (b.start <= a.start and a.stop <= b.stop):
                return None
            rel.append(slice(a.start - b.start, a.stop - b.start))
        else:
            if a.shape != b.shape or not torch.equal(a, b):
                return None
            rel.append(slice(0, len(a)))
    return tuple(rel)


def _elementwise_placed(update, params, grads, state, step, keys):
    """SGD or Adam on a placed tree: ``update`` (the optimizer's own, on
    one-leaf trees) per state block over its region of the parameter's
    block, on the devices holding it; the parameter's block reassembled
    from its regions (gathered over the data axis where ZeRO-1 splits the
    state)."""
    p_leaves, g_leaves = _leaves(params), _leaves(grads)
    s_leaves = [_leaves(state[k]) for k in keys]
    new_p, new_s = [], [[] for _ in keys]
    for i, (P, G) in enumerate(zip(p_leaves, g_leaves)):
        S = [sl[i] for sl in s_leaves]
        ref = S[0] if S else P
        pieces = {k: [] for k in range(len(P.parts))}
        s_parts = [[None] * len(ref.parts) for _ in keys]
        for m, region in enumerate(ref.regions):
            k = next(k for k, r in enumerate(P.regions)
                     if _within(region, r) is not None)
            rel = _within(region, P.regions[k])
            with counting.device(ref.holders(m)):
                p_sub = sharding._take(P.parts[k], rel)
                g_sub = sharding._take(G.parts[k], rel)
                st = {key: {"x": S[n].parts[m]} for n, key in enumerate(keys)}
                out_p, out_s = update({"x": p_sub}, {"x": g_sub}, st, step)
            pieces[k].append((rel, out_p["x"]))
            for n, key in enumerate(keys):
                s_parts[n][m] = out_s[key]["x"]
        parts = []
        for k, part in enumerate(P.parts):
            got = pieces[k]
            if len(got) == 1 and tuple(got[0][1].shape) == tuple(part.shape):
                parts.append(got[0][1])
                continue
            with counting.device(P.holders(k)):
                whole = torch.empty_like(part)
                for rel, sub in got:
                    sharding._put(whole, rel, sub)
                n = whole.numel() * whole.element_size()
                counting.collective("all-gather", n * (len(got) - 1)
                                    / len(got))
            parts.append(whole)
        new_p.append(P.with_parts(parts))
        for n in range(len(keys)):
            new_s[n].append(S[n].with_parts(s_parts[n]))
    out_state = {key: _rebuild(state[key], iter(new_s[n]))
                 for n, key in enumerate(keys)}
    return _rebuild(params, iter(new_p)), out_state


def _adafactor_placed(params, grads, state, step, lr, eps, decay):
    """Adafactor on a placed tree: per block g^2 + eps's row and column
    sums, all-reduced into the whole vr and vc; the update per block; the
    RMS's sum of squares all-reduced; the state kept in its blocks."""
    p_leaves, g_leaves = _leaves(params), _leaves(grads)
    s_leaves = _leaves_state(state["f"], params)
    new_p, new_s = [], []
    for P, G, S in zip(p_leaves, g_leaves, s_leaves):
        dev = P.parts[0].device
        t = _step_f32(step, P.parts[0])
        beta = 1.0 - t ** (-decay)
        # one block per region (copies of a region on other cards alike)
        seen, uniq = set(), []
        for k, r in enumerate(P.regions):
            key = sharding._region_key(r)
            if key not in seen:
                seen.add(key)
                uniq.append(k)
        g2 = {}
        for k in uniq:
            with counting.device(P.holders(k)):
                g2[k] = G.parts[k].float().square() + eps
        with counting.replicated():
            if len(P.shape) >= 2:
                vr_acc = torch.zeros(P.shape[:-1], dtype=torch.float32,
                                     device=dev)
                vc_acc = torch.zeros(P.shape[:-2] + P.shape[-1:],
                                     dtype=torch.float32, device=dev)
                for k in uniq:
                    r = P.regions[k]
                    _put_add(vr_acc, r[:-1], g2[k].sum(dim=-1).to(dev))
                    _put_add(vc_acc, r[:-2] + r[-1:],
                             g2[k].sum(dim=-2).to(dev))
                for acc in (vr_acc, vc_acc):
                    counting.collective("all-reduce", 2 * acc.numel() * 4)
                vr = beta * S["vr"].whole(dev) + \
                    (1 - beta) * vr_acc / P.shape[-1]
                vc = beta * S["vc"].whole(dev) + \
                    (1 - beta) * vc_acc / P.shape[-2]
                vc_mean = vc.mean(dim=-1).clamp_min(eps)
            else:
                v = None
        us = {}
        for k in uniq:
            r = P.regions[k]
            with counting.device(P.holders(k)):
                if len(P.shape) >= 2:
                    vr_k = sharding._take(vr, r[:-1]).to(g2[k].device)
                    vc_k = sharding._take(vc, r[:-2] + r[-1:]).to(
                        g2[k].device)
                    vm_k = sharding._take(vc_mean, r[:-2]).to(g2[k].device)
                    denom = vr_k[..., None] * vc_k[..., None, :] / \
                        vm_k[..., None, None]
                else:
                    v_k = _state_block(S["v"], r)
                    v_new = beta * v_k + (1 - beta) * g2[k]
                    us[("v", k)] = v_new
                    denom = v_new
                us[k] = G.parts[k].float() * torch.rsqrt(denom + eps)
        with counting.replicated():
            sq = sum(us[k].square().sum().to(dev) for k in uniq)
            counting.collective("all-reduce", 2 * 4)
            n = 1
            for d in P.shape:
                n *= d
            rms = torch.sqrt(sq / n + 1e-12).clamp_min(1.0)
        parts = []
        for k, part in enumerate(P.parts):
            src = next(u for u in uniq if sharding._region_key(
                P.regions[u]) == sharding._region_key(P.regions[k]))
            with counting.device(P.holders(k)):
                parts.append((part.float() - lr * (us[src] / rms.to(
                    part.device)).to(part.device)).to(part.dtype))
        new_p.append(P.with_parts(parts))
        if len(P.shape) >= 2:
            new_s.append({"vr": _restate(S["vr"], vr),
                          "vc": _restate(S["vc"], vc)})
        else:
            new_s.append({"v": _restate_blocks(S["v"], P, uniq, us)})
    return (_rebuild(params, iter(new_p)),
            {"f": _rebuild_state(state["f"], params, iter(new_s))})


def _put_add(acc, region, src):
    """``acc[region] += src`` (slices, at most one index tensor)."""
    view, dim = acc, None
    for d, r in enumerate(region):
        if isinstance(r, slice):
            if (r.start, r.stop) != (0, acc.shape[d]):
                view = view.narrow(d, r.start, r.stop - r.start)
        else:
            dim = d
    if dim is None:
        view.add_(src)
    else:
        view.index_add_(dim, region[dim].to(acc.device), src)


def _restate(S, whole):
    """The whole statistic ``whole`` cut into ``S``'s blocks."""
    return S.with_parts([sharding._take(whole, r).to(p.device).clone()
                         for p, r in zip(S.parts, S.regions)])


def _state_block(S, region):
    """A 1-D state's block over ``region`` (read from the block that
    holds it)."""
    for p, r in zip(S.parts, S.regions):
        rel = _within(region, r)
        if rel is not None:
            return sharding._take(p, rel)
    return sharding._take(S.whole(), region)


def _restate_blocks(S, P, uniq, us):
    """A 1-D state's new blocks from the updated parameter blocks'."""
    whole = torch.empty(S.shape, dtype=torch.float32,
                        device=S.parts[0].device)
    for k in uniq:
        sharding._put(whole, P.regions[k], us[("v", k)].to(whole.device))
    return _restate(S, whole)


def _leaves_state(tree, like):
    """The Adafactor state's per-parameter dicts ({vr, vc} or {v}), in the
    parameters' leaf order."""
    if isinstance(like, dict):
        out = []
        for k in like:
            out += _leaves_state(tree[k], like[k])
        return out
    return [tree]


def _rebuild_state(tree, like, it):
    if isinstance(like, dict):
        return {k: _rebuild_state(tree[k], like[k], it) for k in like}
    return next(it)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name!r}")
