"""Sharding (port of ``repro.sharding``).

**Logical axes.** Models name each parameter's, cache's and activation's
dims by logical axis ("vocab", "heads", "act_seq", ...); a rules table
(``launch.sharding_rules.base_rules``) maps them to mesh axes, installed
with a ``Mesh`` by ``logical_rules``. ``resolve_spec`` turns a leaf's axes
into a spec, a tuple of one entry per dim (a mesh-axis name, a tuple of
them, or None), with the reference's two demotions: a dim its mesh axes
do not divide is replicated (warned once per (name, axis, dim)), and a
mesh axis is used once per spec. ``named_sharding`` returns the mesh with
that spec (``NamedSharding``).

**Placement.** ``place(tensor, spec, mesh)`` gives a leaf its per-device
blocks, a ``Placed``: disjoint parts of the whole, each with its region
and the mesh coordinates that hold it. Where two coordinates name the
same device a replicated block is one tensor object, not a copy (so
autograd sums its gradient over the shards that read it); on meta the
blocks are meta. A ``layout`` places a dim's columns in index groups
instead of contiguous blocks (the Mamba2 mixer's per-head columns,
``models.ssm.head_layout``). The batch is not cut by placement: the
single controller runs a step's whole batch once per model shard, and the
counting pass (``counting``) gives a device the data axis's share of it.

**Tensor parallelism.** With a placed parameter tree on a mesh whose
"model" axis is tp > 1, and some parameter split over it (under
``pure_dp`` none is, and the model axis splits the batch instead:
``models.model._tp``), the models run each model shard's work explicitly
(``TensorParallel``: the shards' devices, their counting scopes and the
collectives). An activation is an ``Act``, one tensor per model shard:
whole on each (replicated), split along a dim, or partial sums whose sum
is the value. ``constrain`` is where its layout changes, to the layout
its logical axes resolve to: partial sums are all-reduced, or
reduce-scattered where the spec splits a dim (sequence parallelism,
"act_seq"); a split dim is all-gathered. Each collective is block copies
(``.to(device)``) and explicit sums, counted per shard by
``counting.collective`` at the ring's bytes: an all-reduce of n bytes moves
2 (tp - 1) / tp x n through each device, a reduce-scatter or all-gather
(tp - 1) / tp x n (n the whole tensor's bytes).

**Worker-axis sharding.** The W (or enrolled-N) rows of every per-worker
buffer split over an ordered list of torch devices, one per shard
(``WorkerShards.shard_leading``: a list of row blocks, which the round
programs run block by block, ``core.engine``; the transport between
blocks is ``core.gossip.mix_pytree_sharded``). Everything that is not a
per-worker row stays on shard 0's device.

A device list may name one device several times: ``["cuda:0"] * 8`` runs
eight shards (or a (2, 4) mesh) on one card, every operation, block copies
included, then on that card; ``["cpu"] * 8`` runs them on the CPU;
``["meta"] * 8`` makes the dry run's mesh (``launch.mesh``), which
allocates nothing. This stands in for the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``, which torch has no
counterpart of. Distinct cards make the block copies peer copies.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import warnings
from typing import Optional, Sequence

import torch

from repro_torch import counting
from repro_torch.device import resolve_device

_DEMOTION_WARNED: set = set()
_state = threading.local()


def _ctx():
    """The thread's sharding context: ``rules`` and ``mesh`` (None
    outside ``logical_rules``)."""
    if not hasattr(_state, "rules"):
        _state.rules = None
        _state.mesh = None
    return _state


@contextlib.contextmanager
def logical_rules(mesh, rules: dict):
    """Install a mesh + logical -> mesh-axis rules for ``resolve_spec``,
    ``constrain`` and the model code under this context. ``rules`` maps a
    logical axis name to a mesh axis name, a tuple of them, or None
    (replicated)."""
    s = _ctx()
    prev = (s.rules, s.mesh)
    s.rules, s.mesh = rules, mesh
    try:
        yield
    finally:
        s.rules, s.mesh = prev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes: ``devices[i][j]`` is the device
    at index i of the first axis and j of the second (a device may
    repeat). ``shape`` maps each axis name to its size, as a JAX mesh's
    does."""
    devices: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        sizes, grid = [], self.devices
        for _ in self.axis_names:
            sizes.append(len(grid))
            grid = grid[0]
        return dict(zip(self.axis_names, sizes))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` of ``shape`` over a flat device list in row-major order
    (the reference's ``jax.make_mesh``). ``devices`` such as ``["cuda:0"]
    * 8`` or ``["cpu"] * 8`` may repeat a device; without it the mesh takes
    the first prod(shape) visible cards, raising ``ValueError`` when fewer
    are visible."""
    shape, names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(names) or min(shape, default=0) < 1:
        raise ValueError(f"make_mesh: shape {shape} for axes {names}")
    n = math.prod(shape)
    if devices is None:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"make_mesh: a {shape} mesh needs {n} devices "
                             f"but only {visible} are visible (pass devices="
                             f"['cuda:0'] * {n} to put it on one card)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"make_mesh: {len(devs)} devices for a {shape} "
                         f"mesh")

    def grid(flat, dims):
        if len(dims) == 1:
            return tuple(flat)
        step = len(flat) // dims[0]
        return tuple(grid(flat[i * step:(i + 1) * step], dims[1:])
                     for i in range(dims[0]))
    return Mesh(grid(devs, shape), names)


# ---------------------------------------------------------------------------
# Logical axes -> specs (the reference's resolve_spec)
# ---------------------------------------------------------------------------

def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def resolve_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Optional[tuple]:
    """Resolve logical axes -> a spec (one entry per dim: a mesh axis, a
    tuple of them, or None) under the current rules; None outside
    ``logical_rules``.

    If ``shape`` is given, any dim not divisible by its mesh-axis product
    is demoted to replicated, warned once per (logical name, mesh axis,
    dim); a mesh axis already used by an earlier dim is skipped, as in the
    reference."""
    s = _ctx()
    if s.rules is None or s.mesh is None:
        return None
    spec = []
    used = set()
    for i, name in enumerate(logical_axes):
        axis = s.rules.get(name) if name is not None else None
        if axis is not None:
            key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
            if used & set(key):
                axis = None  # a mesh axis may appear only once in a spec
            elif shape is not None and shape[i] % _mesh_axis_size(s.mesh,
                                                                   axis):
                wkey = (name, key, shape[i])
                if wkey not in _DEMOTION_WARNED:
                    _DEMOTION_WARNED.add(wkey)
                    warnings.warn(
                        f"sharding: logical axis {name!r} (dim {shape[i]}) "
                        f"is not divisible by mesh axis {axis!r} "
                        f"(size {_mesh_axis_size(s.mesh, axis)}) — demoting "
                        f"to replicated; pad the dim for an even shard",
                        RuntimeWarning, stacklevel=3)
                axis = None
            else:
                used |= set(key)
        if isinstance(axis, (tuple, list)):
            # a one-axis tuple is its name, as in JAX's PartitionSpec
            axis = axis[0] if len(axis) == 1 else tuple(axis)
        spec.append(axis)
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the port's counterpart of JAX's)."""
    mesh: Mesh
    spec: tuple


def named_sharding(logical_axes, shape=None) -> Optional[NamedSharding]:
    spec = resolve_spec(logical_axes, shape)
    if spec is None:
        return None
    return NamedSharding(_ctx().mesh, spec)


def axes_of(entry) -> tuple:
    """The mesh axes of a spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ---------------------------------------------------------------------------
# Placement: a leaf's per-device blocks
# ---------------------------------------------------------------------------

def _coords(mesh: Mesh):
    return list(itertools.product(*(range(n)
                                     for n in mesh.shape.values())))


def _device_at(mesh: Mesh, coord):
    d = mesh.devices
    for i in coord:
        d = d[i]
    return d


def flat_index(mesh: Mesh, coord) -> int:
    """A coordinate's row-major index in the mesh (the counting pass's
    device number: i * tp + j on a ("data", "model") mesh)."""
    n = 0
    for size, i in zip(mesh.shape.values(), coord):
        n = n * size + i
    return n


def _region_key(region):
    return tuple((r.start, r.stop) if isinstance(r, slice)
                 else ("idx",) + tuple(r.tolist()) for r in region)


def _take(t, region):
    """``t``'s elements in ``region`` (a tuple of slices and at most one
    index tensor, one per dim): a view for slices, a gather for an index
    tensor."""
    out = t
    for dim, r in enumerate(region):
        if isinstance(r, slice):
            if r != slice(None) and (r.start, r.stop) != (0, t.shape[dim]):
                out = out.narrow(dim, r.start, r.stop - r.start)
        else:
            out = out.index_select(dim, r.to(out.device))
    return out


class Placed:
    """One leaf's per-device blocks. ``parts`` are disjoint regions of the
    whole (``regions``: a slice or an index tensor per dim); ``owners``
    maps each mesh coordinate to the ids of the parts it holds (one, or a
    layout's (own group, shared group)). ``shape``, ``dtype`` and ``spec``
    are the whole leaf's."""

    def __init__(self, shape, dtype, spec, mesh, parts, regions, owners):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.spec = tuple(spec)
        self.mesh = mesh
        self.parts = list(parts)
        self.regions = list(regions)
        self.owners = dict(owners)

    def __repr__(self):
        return (f"Placed(shape={self.shape}, spec={self.spec}, "
                f"parts={len(self.parts)})")

    @property
    def device(self):
        """Block 0's device (a pod's tree reads its device from a leaf:
        ``launch.steps``)."""
        return self.parts[0].device

    def with_parts(self, parts) -> "Placed":
        """The same placement over new parts (one per part, same
        shapes)."""
        return Placed(self.shape, parts[0].dtype, self.spec, self.mesh,
                      parts, self.regions, self.owners)

    def select(self, r: int) -> "Placed":
        """Layer r of a stacked leaf (its leading "layers" dim, never
        split): views into the parts."""
        return Placed(self.shape[1:], self.dtype, self.spec[1:], self.mesh,
                      [p[r] for p in self.parts],
                      [reg[1:] for reg in self.regions], self.owners)

    def local(self, coord):
        """The block(s) the device at ``coord`` holds: a tensor, or a
        tuple (own group, shared group) under a layout."""
        ids = self.owners[tuple(coord)]
        if len(ids) == 1:
            return self.parts[ids[0]]
        return tuple(self.parts[k] for k in ids)

    def holders(self, k: int) -> tuple:
        """The flat device indices of the coordinates holding part k."""
        return tuple(sorted(flat_index(self.mesh, c)
                            for c, ids in self.owners.items() if k in ids))

    def device_bytes(self, coord) -> int:
        return sum(self.parts[k].numel() * self.parts[k].element_size()
                   for k in self.owners[tuple(coord)])

    def whole(self, device=None):
        """The whole leaf assembled on ``device`` (default part 0's)."""
        dev = self.parts[0].device if device is None else device
        if len(self.parts) == 1:
            return self.parts[0].to(dev)
        out = torch.empty(self.shape, dtype=self.parts[0].dtype, device=dev)
        for p, r in zip(self.parts, self.regions):
            _put(out, r, p.to(dev))
        return out

    def read(self, region, device):
        """The whole leaf's ``region`` (a tuple of slices, one per dim) on
        ``device``: a view of the one part that holds it, else assembled
        from the parts (an all-gather, counted at the receiving shard)."""
        region = tuple(region) + (slice(None),) * (len(self.shape)
                                                     - len(region))
        want = [(r.start or 0, self.shape[d] if r.stop is None else r.stop)
                for d, r in enumerate(region)]
        for p, r in zip(self.parts, self.regions):
            if all(isinstance(x, slice) for x in r):
                have = [(x.start or 0, self.shape[d] if x.stop is None
                         else x.stop) for d, x in enumerate(r)]
                if all(h0 <= w0 and w1 <= h1 for (h0, h1), (w0, w1)
                       in zip(have, want)):
                    rel = tuple(slice(w0 - h0, w1 - h0) for (h0, _), (w0, w1)
                                in zip(have, want))
                    return _take(p, rel).to(device)
        out = _take(self.whole(device), tuple(slice(a, b) for a, b in want))
        nbytes = out.numel() * out.element_size()
        counting.collective("all-gather", nbytes)
        return out


def _put(out, region, src):
    """``out[region] = src`` in place (slices, and at most one index
    tensor)."""
    view, dim = out, None
    for d, r in enumerate(region):
        if isinstance(r, slice):
            if (r.start, r.stop) != (0, out.shape[d]):
                view = view.narrow(d, r.start, r.stop - r.start)
        else:
            dim = d
    if dim is None:
        view.copy_(src)
    else:
        view.index_copy_(dim, region[dim].to(out.device), src)
    return out


def place(tensor, spec, mesh: Mesh, *, layout=None, skip=()) -> Placed:
    """``tensor``'s per-device blocks under ``spec`` on ``mesh``.

    A dim whose spec names mesh axes is cut into contiguous blocks over
    them (row-major over the named axes); ``skip`` names mesh axes not cut
    here (the batch's data axis: see the module docstring). ``layout =
    (dim, groups, shared)`` cuts that dim, where the spec names "model",
    into the index groups ``groups[j]`` for model shard j plus ``shared``,
    held by every shard. Blocks of one region on one device are one
    tensor: ``tensor`` itself where the region is whole, else a copy with
    its own storage (meta on meta)."""
    spec = tuple(spec) + (None,) * (tensor.dim() - len(spec))
    names = list(mesh.shape)
    sizes = mesh.shape
    lay_dim = None
    if layout is not None:
        lay_dim = layout[0] % tensor.dim()
        if axes_of(spec[lay_dim]) != ("model",):
            layout, lay_dim = None, None
    parts, regions, owners, made = [], [], {}, {}
    for coord in _coords(mesh):
        at = dict(zip(names, coord))
        per_dim = []
        for d, entry in enumerate(spec):
            axes = tuple(a for a in axes_of(entry) if a not in skip)
            if d == lay_dim:
                groups, shared = layout[1], layout[2]
                per_dim.append([groups[at["model"]], shared])
                continue
            if not axes:
                per_dim.append([slice(0, tensor.shape[d])])
                continue
            n, k = 1, 0
            for a in axes:
                n *= sizes[a]
                k = k * sizes[a] + at[a]
            b = tensor.shape[d] // n
            per_dim.append([slice(k * b, (k + 1) * b)])
        dev = _device_at(mesh, coord)
        ids = []
        for region in itertools.product(*per_dim):
            key = (_region_key(region), str(dev))
            if key not in made:
                whole = all(isinstance(r, slice) and (r.start, r.stop) ==
                            (0, tensor.shape[d]) for d, r in enumerate(region))
                if tensor.device.type == "meta" or dev.type == "meta":
                    shape = [(r.stop - r.start) if isinstance(r, slice)
                             else len(r) for r in region]
                    part = tensor if whole and tensor.device == dev else \
                        torch.empty(shape, dtype=tensor.dtype, device="meta")
                elif whole:
                    part = tensor.to(dev)
                else:
                    part = _take(tensor, region).to(dev, copy=True) \
                        .contiguous()
                made[key] = len(parts)
                parts.append(part)
                regions.append(region)
            ids.append(made[key])
        owners[coord] = tuple(ids)
    return Placed(tensor.shape, tensor.dtype, spec, mesh, parts, regions,
                  owners)


def is_placed(tree) -> bool:
    """Whether a tree of dicts holds a ``Placed`` leaf."""
    if isinstance(tree, Placed):
        return True
    if isinstance(tree, dict):
        return any(is_placed(v) for v in tree.values())
    return False


def placed_leaves(tree, prefix=()):
    """(path, Placed) of every placed leaf of a tree of dicts, in
    order."""
    if isinstance(tree, Placed):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += placed_leaves(v, prefix + (k,))
        return out
    return []


def map_placed(fn, tree):
    """``fn`` on every ``Placed`` leaf of a tree of dicts."""
    if isinstance(tree, Placed):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_placed(fn, v) for k, v in tree.items()}
    return tree


def unplace(tree, device=None):
    """A tree with every ``Placed`` leaf assembled whole."""
    return map_placed(lambda p: p.whole(device), tree)


def local(tree, coord, keep=None):
    """The blocks the device at ``coord`` holds, leaf by leaf (plain
    leaves pass through); ``keep(p)`` true keeps a leaf ``Placed`` (the
    leaves split over the data axis, which expert parallelism reads)."""
    def one(p):
        if keep is not None and keep(p):
            return p
        return p.local(coord)
    return map_placed(one, tree)


def splits_over(p: Placed, axis: str) -> bool:
    return any(axis in axes_of(e) for e in p.spec)


def place_tree(tree, axes, mesh: Mesh, rules: dict, *, layouts=None,
               skip=()):
    """Place every leaf of a tree of dicts of tensors by its logical axes
    (the same tree of tuples) under ``rules`` (``layouts``: a same-shaped
    tree of ``(dim, fn(tp) -> (groups, shared))`` or None)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, axes[k], mesh, rules,
                              layouts=None if layouts is None
                              else layouts.get(k), skip=skip)
                for k, v in tree.items()}
    with logical_rules(mesh, rules):
        spec = resolve_spec(axes, tuple(tree.shape))
    lay = None
    if layouts is not None:
        dim, fn = layouts
        groups, shared = fn(mesh.shape.get("model", 1))
        lay = None if groups is None else (dim, groups, shared)
    return place(tree, spec, mesh, layout=lay, skip=skip)


# ---------------------------------------------------------------------------
# Tensor parallelism: the model shards' work and their collectives
# ---------------------------------------------------------------------------

class Act:
    """A tensor-parallel activation: ``parts[j]`` on model shard j's
    device; whole on each shard (``split`` None, not ``partial``), split
    along dim ``split`` (each shard its contiguous 1/tp block), or partial
    sums (``partial``: the value is their sum)."""

    def __init__(self, parts, split=None, partial=False):
        self.parts = list(parts)
        self.split = split
        self.partial = partial

    def __len__(self):
        return len(self.parts)


class TensorParallel:
    """The model axis of a ("data", "model") mesh as explicit per-shard
    work: shard j runs on ``devices[j]`` (data coordinate 0) inside
    ``counting.shard(j)``; ``coord(j)`` is its mesh coordinate."""

    def __init__(self, mesh: Mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules or {}
        self.size = mesh.shape.get("model", 1)
        self.devices = [_device_at(mesh, self.coord(j))
                        for j in range(self.size)]

    def coord(self, j: int, i: int = 0):
        return tuple(j if a == "model" else (i if a == "data" else 0)
                     for a in self.mesh.shape)

    def each(self, fn):
        """``[fn(j) for j in shards]``, each inside its counting scope."""
        out = []
        for j in range(self.size):
            with counting.shard(j):
                out.append(fn(j))
        return out

    def params(self, tree, j: int):
        """Model shard j's blocks of a placed tree; leaves split over the
        data axis stay ``Placed``."""
        return local(tree, self.coord(j),
                     keep=lambda p: splits_over(p, "data"))

    def read(self, leaf, j: int):
        """A whole (small) leaf on shard j's device: gathered from its
        blocks where it is split (an all-gather, counted)."""
        if isinstance(leaf, Placed):
            return leaf.read((), self.devices[j])
        return leaf.to(self.devices[j])

    def spec(self, *axes, shape=None):
        with logical_rules(self.mesh, self.rules):
            return resolve_spec(axes, shape)

    # -- collectives ----------------------------------------------------
    def _count(self, kind, nbytes, factor):
        for j in range(self.size):
            with counting.shard(j):
                counting.collective(kind, factor * nbytes)

    def all_reduce(self, act: Act) -> Act:
        """Partial sums -> the sum whole on every shard."""
        n = act.parts[0].numel() * act.parts[0].element_size()
        tp = self.size
        self._count("all-reduce", n, 2 * (tp - 1) / tp)
        return Act(self.each(lambda j: _sum_on(act.parts,
                                                self.devices[j])))

    def all_reduce_max(self, act: Act) -> Act:
        """Per-shard values -> their elementwise max on every shard."""
        n = act.parts[0].numel() * act.parts[0].element_size()
        tp = self.size
        self._count("all-reduce", n, 2 * (tp - 1) / tp)

        def one(j):
            out = None
            for p in act.parts:
                p = p.to(self.devices[j])
                out = p if out is None else torch.maximum(out, p)
            return out
        return Act(self.each(one))

    def reduce_scatter(self, act: Act, dim: int) -> Act:
        """Partial sums -> shard j holds block j of the sum along
        ``dim``."""
        n = act.parts[0].numel() * act.parts[0].element_size()
        tp = self.size
        self._count("reduce-scatter", n, (tp - 1) / tp)
        b = act.parts[0].shape[dim] // tp

        def one(j):
            return _sum_on([p.narrow(dim, j * b, b) for p in act.parts],
                           self.devices[j])
        return Act(self.each(one), split=dim)

    def all_gather(self, act: Act, dim=None) -> Act:
        """Split blocks -> the whole on every shard."""
        dim = act.split if dim is None else dim
        n = sum(p.numel() * p.element_size() for p in act.parts)
        tp = self.size
        self._count("all-gather", n, (tp - 1) / tp)
        return Act(self.each(lambda j: torch.cat(
            [p.to(self.devices[j]) for p in act.parts], dim=dim)))

    def gather(self, act: Act, j: int = 0):
        """Any layout -> one whole tensor on shard j's device (the
        caller's copy: the returned logits), the other shards' blocks
        received there."""
        if act.partial:
            return self.all_reduce(act).parts[j]
        if act.split is None:
            return act.parts[j]
        n = sum(p.numel() * p.element_size() for p in act.parts)
        with counting.shard(j):
            counting.collective("all-gather", (self.size - 1) / self.size
                                * n)
            return torch.cat([p.to(self.devices[j]) for p in act.parts],
                             dim=act.split)

    def scatter(self, act: Act, dim: int) -> Act:
        """Whole on every shard -> shard j keeps its block (no
        traffic)."""
        b = act.parts[0].shape[dim] // self.size
        return Act(self.each(lambda j: act.parts[j].narrow(dim, j * b, b)),
                   split=dim)

    def whole(self, act: Act) -> Act:
        """Any layout -> whole on every shard."""
        if act.partial:
            return self.all_reduce(act)
        if act.split is not None:
            return self.all_gather(act)
        return act

    def constrain(self, act: Act, *axes) -> Act:
        """The layout ``axes`` resolve to: their dim that the spec puts on
        "model" split, every other dim whole."""
        shape = tuple(act.parts[0].shape)
        if act.split is not None:
            shape = shape[:act.split] + (shape[act.split] * self.size,) + \
                shape[act.split + 1:]
        spec = self.spec(*axes, shape=shape) or (None,) * len(axes)
        dims = [d for d, e in enumerate(spec) if "model" in axes_of(e)]
        want = dims[0] if dims else None
        if act.partial:
            if want is None:
                return self.all_reduce(act)
            return self.reduce_scatter(act, want)
        if act.split == want:
            return act
        act = self.whole(act)
        return act if want is None else self.scatter(act, want)


def constrain(x, *logical_axes):
    """The layout ``logical_axes`` resolve to under the current rules: an
    ``Act`` changes layout (``TensorParallel.constrain``); a whole tensor
    on one device, or anything outside ``logical_rules``, is returned as
    it is."""
    s = _ctx()
    if not isinstance(x, Act) or s.mesh is None:
        return x
    return TensorParallel(s.mesh, s.rules).constrain(x, *logical_axes)


def _sum_on(parts, device):
    out = None
    for p in parts:
        p = p.to(device)
        out = p if out is None else out + p
    return out


def tensor_parallel(params) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of a placed tree on its leaves' mesh, under
    the active rules (none outside ``logical_rules``: every activation
    whole), or None for a plain tree."""
    leaves = placed_leaves(params)
    if not leaves:
        return None
    return TensorParallel(leaves[0][1].mesh, _ctx().rules)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts and dataclasses (None and
    other leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def tree_zip(fn, trees: Sequence):
    """``fn(list of tensors)`` on the matching tensors of trees of one
    structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    if isinstance(first, dict):
        return {k: tree_zip(fn, [t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: tree_zip(fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)})
    return first


@dataclasses.dataclass(frozen=True)
class WorkerShards:
    """The worker-axis sharding of a round program run: one device per
    shard, in shard order (a device may repeat)."""
    devices: tuple

    @property
    def shards(self) -> int:
        return len(self.devices)

    def even(self, n: int) -> bool:
        """Whether ``n`` rows split evenly; warns once per (n, shards)
        when they do not, with the reference's text."""
        if n % self.shards == 0:
            return True
        key = ("worker_rows", n, self.shards)
        if key not in _DEMOTION_WARNED:
            _DEMOTION_WARNED.add(key)
            warnings.warn(
                f"sharding: worker count {n} is not divisible by "
                f"{self.shards} shards — state buffers stay "
                f"replicated (the sharded transport still pads and "
                f"runs); pad W for the per-device memory win",
                RuntimeWarning, stacklevel=3)
        return False

    def bounds(self, n: int):
        """The row blocks ``[(r0, r1, device), ...]`` of ``n`` rows: one
        per shard when ``n`` divides evenly, else the one block ``(0, n,
        devices[0])`` (the state stays whole; only the transport pads)."""
        if not self.even(n):
            return [(0, n, self.devices[0])]
        b = n // self.shards
        return [(s * b, (s + 1) * b, d) for s, d in enumerate(self.devices)]

    def shard_leading(self, tree, n: int) -> list:
        """The placement rule (the reference's ``shard_leading``): a list of
        trees, one per row block of ``bounds(n)``; every tensor whose
        leading dim is ``n`` is cut into the block's rows on the block's
        device, every other tensor copied to it whole."""
        def part(r0, r1, dev):
            def cut(x):
                if x.ndim >= 1 and x.shape[0] == n:
                    x = x[r0:r1]
                # a copy even on the same device: a block owns its rows
                return x.to(dev, copy=True).contiguous()
            return tree_map(cut, tree)
        return [part(*b) for b in self.bounds(n)]

    def gather_leading(self, blocks: list, n: int):
        """Inverse of ``shard_leading(tree, n)``: the blocks' rows
        concatenated on shard 0's device (a tensor that was copied whole
        is taken from the first block)."""
        if len(blocks) == 1:
            return blocks[0]
        dev = self.devices[0]

        def cat(xs):
            if sum(x.shape[0] if x.ndim else 0 for x in xs) == n:
                return torch.cat([x.to(dev) for x in xs])
            return xs[0].to(dev)
        return tree_zip(cat, blocks)


def worker_shards(shards: Optional[int], device,
                  devices: Optional[Sequence] = None
                  ) -> Optional[WorkerShards]:
    """The ``WorkerShards`` of a run, or None for an unsharded one (no
    more than one shard, as the reference's drivers read ``shards``).

    ``devices`` (a list such as ``["cuda:0"] * 4``) names the shard devices
    explicitly; otherwise the shards take ``["cpu"] * shards`` on the CPU
    and the first ``shards`` visible cards on CUDA, raising the
    reference's ``ValueError`` when fewer are visible."""
    dev = torch.device(device)
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if shards is not None and int(shards) != len(devs):
            raise ValueError(f"shards={shards} but {len(devs)} shard "
                             f"devices given")
        if any(d.type != dev.type for d in devs):
            raise ValueError(f"shard devices {[str(d) for d in devs]} are "
                             f"not all on the run's device type {dev.type}")
    elif shards is None or int(shards) <= 1:
        return None
    elif dev.type == "cpu":
        devs = (dev,) * int(shards)
    else:
        visible = torch.cuda.device_count()
        n = int(shards)
        if n < 1 or n > visible:
            raise ValueError(f"worker_mesh: asked for {shards} shards but "
                             f"only {visible} devices are visible (pass "
                             f"shard_devices=['cuda:0'] * {shards} to run "
                             f"them on one card)")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    return WorkerShards(devs) if len(devs) > 1 else None
