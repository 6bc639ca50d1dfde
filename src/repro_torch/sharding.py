"""Sharding (port of ``repro.sharding``). Worker-axis sharding: the W (or
enrolled-N) rows of every per-worker buffer split over an ordered list of
torch devices, one per shard.

The reference shards over a 1-D mesh of one process's local devices and
lets GSPMD place every ``[W, ...]`` leaf. Here the placement is explicit:
``WorkerShards.shard_leading`` turns a state (or a data dict) into a list
of row blocks, one per shard device, and the round programs run their
stages block by block (``core.engine``); the transport between blocks is
``core.gossip.mix_pytree_sharded``. Everything that is not a per-worker
row (the draws, the scenario, the cross-device k-block) stays on shard 0's
device.

A device list may name one device several times: ``["cuda:0"] * 4`` runs
four shards on one card (every operation of the sharded path, the ring's
block copies included, then runs on that card), ``["cpu"] * 8`` runs eight
shards on the CPU. This stands in for the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``, which torch has
no counterpart of. Distinct cards make the block copies peer copies.

The model-parallel part is the device mesh that expert parallelism
(``models.moe_eplocal``) reads: ``Mesh``, a grid of devices with named
axes (``("data", "model")``), made by ``make_mesh`` from a device list as
``WorkerShards`` is (``["cuda:0"] * 8`` puts a 4 x 2 mesh on one card),
and installed by ``logical_rules``, whose context ``_ctx()`` holds it as
the reference's does. The reference's logical-axis resolution
(``resolve_spec``, ``constrain``, ``named_sharding``) places GSPMD arrays
on a TPU mesh and is not ported (ROADMAP.md, queue 1a, item 12b): of the
rules ``logical_rules`` installs, only the dry run reads one ("batch",
``launch.costing.batch_split``). ``["meta"] * 8`` makes the dry run's mesh
(``launch.mesh``), which allocates nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import warnings
from typing import Optional, Sequence

import torch

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
    """Install a mesh (and the reference's logical -> mesh-axis rules, kept
    for its signature) for the model code under this context."""
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
