"""Expert-parallel MoE over a ("data", "model") device mesh (the port of
``repro.models.moe_eplocal``, the reference's production MoE path).

The reference runs a ``shard_map`` over one process's mesh, mapped as

    experts  -> "data"  axis  (EP degree = mesh data size)
    expert F -> "model" axis  (TP inside each expert)
    tokens   -> "data"  axis  (batch parallel, same axis as EP)

The port is single-controller, as the worker-axis sharding is: the mesh is
a grid of torch devices (``sharding.make_mesh``: ``["cuda:0"] * 8`` on one
card, ``["cpu"] * 8`` in the tests), installed by
``sharding.logical_rules``; each shard's work runs on its device, each
``all_to_all`` becomes block copies between the devices (``.to(device)``,
no copy where two shards share a device) and each ``psum`` an explicit sum.
No ``torch.distributed`` (ROADMAP.md, ground rules). Every step is
differentiable; the router kernels' gradient is their autograd Function's
(``kernels.ops``).

Per data shard i on the all_to_all path (B divisible by the data axis):

1. route: ``ops.moe_route_slots`` on the shard's fp32 router logits, one
   launch per data shard on its first device (its model shards route the
   same tokens alike and take copies). Its ``slot`` is the pair's rank
   among the pairs routed to its expert in flattened order t*k + j, the
   rank the reference's stable argsort gives; its ``src`` (slot -> token)
   replaces the reference's scatter-add into zeros, where each kept slot
   has one source.
2. pack: one gather of the tokens into the [ep, E_loc, C, D] send buffer.
3. dispatch: block [i'] to each model shard of data shard i' (optionally
   float8_e4m3 with bf16 per-slot scales, dequantized on arrival).
4. experts: SwiGLU on each device with its E_loc experts and F / tp
   columns; the model shards' outputs summed on the data shard's first
   device (the psum over "model").
5. combine: block [i] of every data shard's output back to data shard i,
   one gather of each pair's row, weighted by its gate.

Each device reads its experts' blocks: from a placed tree
(``sharding.Placed``: experts -> "data", expert_mlp -> "model",
``launch.steps.place_state``) the block device (i, j) holds, with no
copy; from a whole tree, slices per call (views on the caller's device,
copies on another card).

The shared experts split F over "model" only. The replicated path (B not
divisible by the data axis) routes once with ``ops.moe_router_topk``, runs
each device's local experts over every token and sums over both axes.
A call launches ``ep`` route-and-slot kernels on the all_to_all path and
one router kernel on the replicated path.

``EXCHANGE`` counts the bytes the two all_to_alls move between data
shards (blocks from a shard to itself are not counted): the dispatch into
every device of the mesh, ``tp * ep * (ep - 1)`` blocks of E_loc * C rows
(fp8: one byte an element plus a bf16 scale a row), the combine into each
data shard once, ``ep * (ep - 1)`` blocks in x's dtype.

For the counting pass (``repro_torch.counting``) each device's work runs under
``counting.device`` (its flat index in the mesh, i * tp + j), the
all_to_alls' bytes count as all-to-all at the receiving device, and the
sums over "model" (and, on the replicated path, over both axes) and the
load-balance statistics' average over "data" as all-reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import counting
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.moe import _shared, expert_counts, \
    grouped_capacity, load_balance_loss, router_logits
from repro_torch.sharding import Placed, _ctx

EXCHANGE = {"dispatch": 0, "combine": 0}
FP8_MAX = 448.0                 # float8_e4m3fn's largest finite value


def reset_exchange() -> None:
    EXCHANGE["dispatch"] = EXCHANGE["combine"] = 0


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _exchange(kind: str, nbytes: int) -> None:
    """One all_to_all block of ``nbytes`` into the current device:
    ``EXCHANGE[kind]`` and the counting pass's all-to-all."""
    EXCHANGE[kind] += nbytes
    counting.collective("all-to-all", nbytes)


def _quantize_fp8(x):
    """Per-row (expert, slot) amax-scaled float8_e4m3fn quantization for the
    dispatch: q = x / (amax / 448) in f32, cast; the scale is returned
    rounded to bf16 (an empty row has amax 0, scale 1 and q 0)."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return q, scale.to(torch.bfloat16)


def _dequantize_fp8(q, scale, dtype):
    return (q.float() * scale.float()).to(dtype)


def _check(cfg: ModelConfig, mesh, params):
    """(ep, tp) of the mesh, after the shapes the mesh must split evenly."""
    shape = mesh.shape
    if set(shape) != {"data", "model"}:
        raise ValueError(f"moe_eplocal: mesh axes {tuple(shape)}, expected "
                         f"('data', 'model')")
    ep, tp = shape["data"], shape["model"]
    m = cfg.moe
    if m.num_experts % ep:
        raise ValueError(f"moe_eplocal: {m.num_experts} experts over a data "
                         f"axis of {ep}")
    for name in ("wi", "shared_wi"):
        if name in params and params[name].shape[-1] % tp:
            raise ValueError(f"moe_eplocal: {name}'s F = "
                             f"{params[name].shape[-1]} over a model axis "
                             f"of {tp}")
    return ep, tp


def _leaf(params, name: str, region, dev):
    """``params[name][region]`` on ``dev``: the block a placed leaf holds
    there (``Placed.read``), else a slice of the whole."""
    t = params[name]
    if isinstance(t, Placed):
        return t.read(region, dev)
    return t[region].to(dev)


def _expert_cols(params, e0: int, e1: int, j: int, tp: int, dev):
    """Experts e0:e1's SwiGLU weights with model shard j's F columns on
    ``dev`` (wi, wg split on F's last dim, wo on its rows)."""
    f = params["wi"].shape[-1] // tp
    cols = slice(j * f, (j + 1) * f)
    ex = slice(e0, e1)
    return (_leaf(params, "wi", (ex, slice(None), cols), dev),
            _leaf(params, "wg", (ex, slice(None), cols), dev),
            _leaf(params, "wo", (ex, cols), dev))


def _shared_tp(params, mesh, i: int, xf, tp: int, dev):
    """The shared experts of data shard i's tokens xf, F split over the
    model axis, summed on ``dev`` (the psum over "model")."""
    f = params["shared_wi"].shape[-1] // tp
    out = None
    for j in range(tp):
        dj = mesh.devices[i][j]
        cols = slice(j * f, (j + 1) * f)
        part = {"shared_wi": _leaf(params, "shared_wi",
                                   (slice(None), cols), dj),
                "shared_wg": _leaf(params, "shared_wg",
                                   (slice(None), cols), dj),
                "shared_wo": _leaf(params, "shared_wo", (cols,), dj)}
        with counting.device(i * tp + j):
            ys = _shared(part, xf.to(dj)).to(dev)
            if out is not None:
                counting.collective("all-reduce", _nbytes(ys))
        out = ys if out is None else out + ys
    return out


def _swiglu(rows, wi, wg, wo):
    """[E_loc, R, D] rows through E_loc experts -> [E_loc, R, D]."""
    h = torch.bmm(rows, wi)
    g = torch.bmm(rows, wg)
    return torch.bmm(F.silu(g) * h, wo)


def _local_moe(params, cfg: ModelConfig, x, mesh, ep: int, tp: int,
               cap_factor: float, a2a_fp8: bool):
    """The all_to_all path. x: [B, S, D] (B divisible by ep) -> ([B, S,
    D] on x's device, aux)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    e_loc = e // ep
    b_, s, d = x.shape
    b_loc = b_ // ep
    t = b_loc * s
    cap = grouped_capacity(t, e, k, cap_factor)
    home = [mesh.devices[i][0] for i in range(ep)]

    # ---- 1-2. route and pack, once per data shard ----------------------
    shards = []
    for i, dev in enumerate(home):
        with counting.device(i * tp):
            xf = x[i * b_loc:(i + 1) * b_loc].to(dev).reshape(t, d)
            logits = router_logits({"router": _leaf(params, "router", (),
                                                    dev)}, xf)
            gates, idx, slot, src = ops.moe_route_slots(logits, k, cap)
            idx = idx.long()
            f_loc = expert_counts(idx, e) / t
            p_loc = torch.softmax(logits, dim=-1).mean(dim=0)
            send = F.pad(xf, (0, 0, 0, 1)).index_select(0, src) \
                .view(ep, e_loc, cap, d)
            if i:
                counting.collective("all-reduce", _nbytes(f_loc, p_loc))
        shards.append(dict(xf=xf, gates=gates, idx=idx, slot=slot,
                           send=send, f=f_loc, p=p_loc))

    # the exact global load-balance loss: f and P averaged over "data"
    # before their product
    f_glob = sum(sh["f"].to(x.device) for sh in shards) / ep
    p_glob = sum(sh["p"].to(x.device) for sh in shards) / ep
    aux = e * torch.sum(f_glob * p_glob)

    # ---- 3-4. dispatch, experts, psum over "model" ---------------------
    y_home = []
    for i2 in range(ep):
        y = None
        for j in range(tp):
            dev = mesh.devices[i2][j]
            blocks = []
            with counting.device(i2 * tp + j):
                for i, sh in enumerate(shards):
                    if a2a_fp8:
                        # each device quantizes its own copy, as every
                        # model shard does in the reference (the scales are
                        # per row, so a block's are the buffer's): an fp8
                        # tensor then has one consumer, and no gradient is
                        # summed in fp8
                        q, scale = (a.to(dev)
                                    for a in _quantize_fp8(sh["send"][i2]))
                        if i != i2:
                            _exchange("dispatch", _nbytes(q, scale))
                        blocks.append(_dequantize_fp8(q, scale, x.dtype))
                    else:
                        blk = sh["send"][i2].to(dev)
                        if i != i2:
                            _exchange("dispatch", _nbytes(blk))
                        blocks.append(blk)
                # recv[i] = send_from_shard_i[i2]: each local expert's rows
                # in source-shard order
                recv = torch.stack(blocks).transpose(0, 1) \
                    .reshape(e_loc, ep * cap, d)
                yj = _swiglu(recv, *_expert_cols(params, i2 * e_loc,
                                                 (i2 + 1) * e_loc, j, tp,
                                                 dev)).to(home[i2])
                if y is not None:
                    counting.collective("all-reduce", _nbytes(yj))
            y = yj if y is None else y + yj
        y_home.append(y.view(e_loc, ep, cap, d).transpose(0, 1))

    # ---- 5. return trip and combine ------------------------------------
    outs = []
    for i, sh in enumerate(shards):
        with counting.device(i * tp):
            parts = []
            for i2 in range(ep):
                blk = y_home[i2][i].to(home[i])
                if i != i2:
                    _exchange("combine", _nbytes(blk))
                parts.append(blk)
            back = torch.stack(parts).reshape(e * cap, d)
            keep = sh["slot"] < cap
            at = sh["idx"] * cap + sh["slot"].clamp(max=cap - 1)
            y_tok = back.index_select(0, at.view(-1)).view(t, k, d)
            w = (sh["gates"] * keep).to(x.dtype)
            out = (y_tok * w[..., None]).sum(dim=1)
            if m.num_shared_experts:
                out = out + _shared_tp(params, mesh, i, sh["xf"], tp,
                                       home[i])
        outs.append(out.view(b_loc, s, d).to(x.device))
    return torch.cat(outs), aux


def _local_moe_replicated(params, cfg: ModelConfig, x, mesh, ep: int,
                          tp: int):
    """The replicated-token path (B not divisible by ep): every device
    runs its local experts over all tokens; y accumulates in f32 and is
    summed over both axes. x: [B, S, D] -> ([B, S, D], aux)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    e_loc = e // ep
    b_, s, d = x.shape
    t = b_ * s
    xf = x.reshape(t, d)
    logits = router_logits({"router": _leaf(params, "router", (),
                                            x.device)}, xf)
    gates, idx = ops.moe_router_topk(logits, k)
    idx = idx.long()
    aux = load_balance_loss(torch.softmax(logits, dim=-1), idx, e)

    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for i in range(ep):
        for j in range(tp):
            dev = mesh.devices[i][j]
            with counting.device(i * tp + j):
                xd, gd, idd = xf.to(dev), gates.to(dev), idx.to(dev)
                wi, wg, wo = _expert_cols(params, i * e_loc,
                                          (i + 1) * e_loc, j, tp, dev)
                for jj in range(e_loc):
                    # each token picks an expert at most once: one gate or 0
                    w_tok = (gd * (idd == i * e_loc + jj)).sum(dim=-1)
                    ye = (F.silu(xd @ wg[jj]) * (xd @ wi[jj])) @ wo[jj]
                    y = y + (ye.float() * w_tok[:, None]).to(x.device)
                if i or j:          # the sum over both axes
                    counting.collective("all-reduce", _nbytes(y))
    out = y.to(x.dtype)
    if m.num_shared_experts:
        # tokens are replicated over "data": one data shard's shared
        # output, summed over "model"
        out = out + _shared_tp(params, mesh, 0, xf, tp, x.device)
    return out.view(b_, s, d), aux


def moe_eplocal(params, cfg: ModelConfig, x, *, cap_factor: float = 1.25,
                a2a_fp8: bool = False):
    """Expert-parallel MoE on the mesh of the active sharding context
    (``sharding.logical_rules``). x: [B, S, D] -> ([B, S, D], aux scalar),
    on x's device.

    ``a2a_fp8``: quantize the dispatch to float8_e4m3 with per-slot amax
    scales (the combine stays in x's dtype)."""
    mesh = _ctx().mesh
    if mesh is None:
        # the reference asserts; raised explicitly so that -O keeps it
        raise AssertionError("moe_eplocal requires a mesh context")
    ep, tp = _check(cfg, mesh, params)
    if x.shape[0] % ep:                      # tiny decode batches
        return _local_moe_replicated(params, cfg, x, mesh, ep, tp)
    return _local_moe(params, cfg, x, mesh, ep, tp, cap_factor, a2a_fp8)
