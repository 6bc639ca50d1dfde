"""The counting pass: the flops, bytes, kernel calls, collective bytes and
peak live bytes of a step, counted while the step runs. On torch's
``meta`` device (tensors with shapes and no storage, the counterpart of
the reference's ShapeDtypeStructs) it computes nothing and allocates
nothing: that is the dry run (``launch.dryrun``). On the CPU and on the
card it counts the same program, so the three can be held equal.

    with counting.Counter(split=8, grad_ranks=8) as c:
        step(...)
    c.flops, c.bytes, c.calls, c.peak_bytes     # the whole program
    c.per_device("flops"), c.collectives(), c.peak_device_bytes

What it counts (one ``TorchDispatchMode`` over every aten op):

- **flops**: torch's own formulas (``torch.utils.flop_counter``: mm,
  addmm, bmm, baddbmm, the convolutions, the sdpa ops) and, for each call
  of a kernel wrapper (``kernels.ops``), its ``roofline.kernel_cost``.
  Elementwise work appears in bytes, not in flops. XLA's ``flops``, which
  the reference reads, also counts elementwise operations, so for the same
  program this count is lower.
- **bytes**: every op that is not a view reads its tensor inputs and
  writes its outputs once. This is the traffic of the eager program, which
  the port really runs unfused. A copy from the host to a device (a RoPE
  frequency table made in numpy, say) crosses PCIe, not HBM, and is not
  counted: the CPU, which makes no such copy, then counts what the card
  and meta count. A kernel call adds its ``kernel_cost`` bytes; the ops
  inside a wrapper (its output allocations; on the CPU the plain version)
  are not counted a second time.
- **peak bytes**: the high-water mark of live tensor storage, each storage
  counted once from its first sight (as an op's output, or registered by
  ``track``) until a weakref finalizer sees it freed. Allocator rounding
  and library workspaces are not tensors and are not in it.
- **calls**: kernel calls by name. ``kernels.ops.LAUNCHES`` counts real
  launches only and is not touched.
- **collectives**: bytes by the reference's five kinds: expert
  parallelism's exchanges (all-to-all) and sums (all-reduce) from
  ``models.moe_eplocal``, the pod ring's blocks (collective-permute) from
  ``core.gossip``, and the data axis's gradient all-reduce in closed form,
  2 (D - 1) / D x the gradient bytes (``gradient_allreduce``; listed in
  ``closed_form``). The bytes that cross pods (the pod ring's; the
  gradient all-reduce where its ranks span pods) are also kept apart,
  ``collectives(dcn=True)``: a pod is one node (``launch.mesh``), so they
  take the link between nodes, the rest NVLink.

The kernel wrappers, the models and the gossip transports call this
module's hooks (``kernel``, ``collective``, ``device``, ``pod``,
``replicated``), each a no-op without an active counter; it imports
nothing of the port, so every layer of it may.

**A device's share.** The port is single-controller: one process runs the
whole mesh's work. Work is attributed to places: ops inside
``device(d)`` (``moe_eplocal``'s per-device loops) to device d, ops inside
``replicated()`` (the optimizer update) to every device whole, ops inside
``pod(p)`` (the FL step's pod loop) to pod p, and the rest to the batch,
which splits over ``split`` devices. A device's figure is that of the
busiest device: ``split``'s share of the batch's work, plus the
replicated work, plus its own. Live storage is attributed the same way;
storage made outside those scopes is the batch's, except that a tensor
with the shape of a registered whole leaf or of one layer of it (a
gradient, an accumulator) is counted whole.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_aten = torch.ops.aten
# ops that move no bytes: allocations and relabellings of a storage
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.lift_fresh}
_STACK: list = []                       # the active counters, innermost last


def active():
    """The innermost active ``Counter``, or None."""
    return _STACK[-1] if _STACK else None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None):
    """The tensors of a tree of lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Whether ``func`` writes nothing it is given and returns only fresh
    tensors (no aliasing output): its meta result is a function of its
    arguments' metadata."""
    known = _FUNCTIONAL.get(func)
    if known is None:
        schema = func._schema
        known = _FUNCTIONAL[func] = \
            not any(a.alias_info is not None for a in schema.arguments) \
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns) and len(schema.returns) > 0
    return known


def _key(x):
    """A hashable stand-in for an op argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    return x


_META_CACHE: dict = {}      # (op, argument metadata) -> output metadata


class Counter(TorchDispatchMode):
    """Counts every op run under it (see the module docstring). ``split``:
    the devices the batch splits over; ``grad_ranks``: the devices the
    gradients are all-reduced over (1: none), ``grad_across_pods`` whether
    they span pods."""

    def __init__(self, split: int = 1, grad_ranks: int = 1,
                 grad_across_pods: bool = False):
        super().__init__()
        self.split = max(int(split), 1)
        self.grad_ranks = max(int(grad_ranks), 1)
        self.grad_across_pods = bool(grad_across_pods)
        self.calls: dict = defaultdict(int)
        self.ops: dict = defaultdict(int)        # non-view aten ops by name
        # counted bytes by aten op name, and by "kernel:<name>"
        self.op_bytes: dict = defaultdict(float)
        self.closed_form: set = set()
        self._flops: dict = defaultdict(float)   # place -> flops
        self._bytes: dict = defaultdict(float)
        self._coll: dict = defaultdict(lambda: defaultdict(float))
        self._dcn: dict = defaultdict(lambda: defaultdict(float))
        self._pod = self._dev = None
        self._repl = False
        self._quiet = 0
        self._live: dict = {}                    # storage -> (nbytes, tag)
        # live bytes by pod: whole, the batch's, and by mesh device
        self._whole: dict = defaultdict(int)
        self._split: dict = defaultdict(int)
        self._on_dev: dict = defaultdict(int)    # (pod, device) -> bytes
        self._whole_shapes: set = set()
        self.live_bytes = self.peak_bytes = 0
        self.peak_device_bytes = 0.0

    # -- the mode --------------------------------------------------------
    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        if not _STACK:
            _META_CACHE.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = _run(func, args, kwargs, ins)
        if not self._quiet and not func.is_view \
                and func.overloadpacket not in _NO_TRAFFIC:
            outs = _tensors(out)
            if any(t.device.type == "cpu" for t in ins) and \
                    any(t.device.type != "cpu" for t in outs):
                self._track(out)        # a host-to-device copy: not counted
                return out
            packet = func.overloadpacket
            nbytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
            self.ops[str(packet)] += 1
            self.op_bytes[str(packet)] += nbytes
            flops = flop_registry[packet](*args, **kwargs, out_val=out) \
                if packet in flop_registry else 0
            self._add(flops, nbytes)
        self._track(out)
        return out

    def _place(self):
        return (self._pod, self._dev, self._repl)

    def _add(self, flops, nbytes):
        place = self._place()
        self._flops[place] += flops
        self._bytes[place] += nbytes

    # -- live storage ----------------------------------------------------
    def _kind(self, t):
        if self._dev is not None:
            return ("device", self._dev)
        if self._repl or tuple(t.shape) in self._whole_shapes:
            return "whole"
        return "split"

    def _track(self, out, kind=None, pod=None):
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            tag = (self._pod if pod is None else pod,
                   self._kind(t) if kind is None else kind)
            self._live[key] = (n, tag)
            self._count_live(tag, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self._device_live())
            weakref.finalize(st, self._release, key)

    def _count_live(self, tag, n):
        pod, kind = tag
        if kind == "whole":
            self._whole[pod] += n
        elif kind == "split":
            self._split[pod] += n
        else:
            self._on_dev[(pod, kind[1])] += n

    def _release(self, key):
        n, tag = self._live.pop(key, (0, None))
        if tag is not None:
            self._count_live(tag, -n)
            self.live_bytes -= n

    def _device_live(self) -> float:
        """The live bytes of the busiest device now."""
        pods = {p for p in (*self._whole, *self._split)} | \
            {p for p, _ in self._on_dev}
        pods = {p for p in pods if p is not None} or {None}
        best = 0.0
        for p in pods:
            shared = p is not None
            own = {}
            for (q, d), n in self._on_dev.items():
                if q == p or (shared and q is None):
                    own[d] = own.get(d, 0) + n
            best = max(best, self._whole[p] + shared * self._whole[None]
                       + (self._split[p] + shared * self._split[None])
                       / self.split + max(own.values(), default=0))
        return best

    def track(self, tree, *, kind: str = "whole", pod=None):
        """Register tensors made before the count (parameters, optimizer
        state: ``kind="whole"``; a batch or a decode cache: ``"split"``)
        as live. A whole leaf's shape, and one layer's, marks later
        tensors of that shape whole (gradients, accumulators)."""
        if kind == "whole":
            for t in _tensors(tree):
                self._whole_shapes.add(tuple(t.shape))
                if t.dim() > 1:
                    self._whole_shapes.add(tuple(t.shape[1:]))
        self._track(tree, kind=kind, pod=pod)

    # -- results ---------------------------------------------------------
    @property
    def flops(self) -> float:
        return sum(self._flops.values())

    @property
    def bytes(self) -> float:
        return sum(self._bytes.values())

    def _share(self, acc) -> float:
        """A device's share of ``acc`` (place -> amount): the busiest
        pod's batch work over ``split``, its replicated work, and its
        busiest device's own."""
        def one(p):
            batch = sum(v for (q, d, r), v in acc.items()
                        if q == p and d is None and not r)
            repl = sum(v for (q, d, r), v in acc.items()
                       if q == p and d is None and r)
            devs = defaultdict(float)
            for (q, d, r), v in acc.items():
                if q == p and d is not None:
                    devs[d] += v
            return batch / self.split + repl + max(devs.values(), default=0)
        pods = [one(p) for p in {q for q, _, _ in acc if q is not None}]
        return one(None) + max(pods, default=0.0)

    def per_device(self, what: str) -> float:
        """A device's ``"flops"`` or ``"bytes"``."""
        return self._share({"flops": self._flops, "bytes": self._bytes}[what])

    def collectives(self, per_device: bool = True, dcn: bool = False) -> dict:
        """Collective bytes by kind: a device's (default) or the whole
        program's; with ``dcn`` only those that cross pods."""
        acc = self._dcn if dcn else self._coll
        return {k: (self._share(acc[k]) if per_device
                    else sum(acc[k].values())) for k in COLLECTIVES}



def _run(func, args, kwargs, tensors):
    """``func`` on its arguments; on meta, a functional op's output is made
    from the metadata its first call gave for the same argument metadata
    (torch's meta kernels, many of them Python references, cost far more
    than the counting itself)."""
    if not tensors or any(t.device.type != "meta" for t in tensors) \
            or not _functional(func):
        return func(*args, **kwargs)
    try:
        key = (func, _key(args), _key(kwargs))
        hash(key)
    except TypeError:
        return func(*args, **kwargs)
    meta = _META_CACHE.get(key)
    if meta is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        if not all(isinstance(o, torch.Tensor) and o.storage_offset() == 0
                   for o in outs):
            return out
        _META_CACHE[key] = (isinstance(out, tuple), [
            (tuple(o.shape), o.stride(), o.dtype) for o in outs])
        return out
    is_tuple, outs = meta
    made = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in outs)
    return made if is_tuple else made[0]


# ---------------------------------------------------------------------------
# Hooks the port's code calls; each is a no-op without an active counter
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _scoped(attr: str, value):
    c = active()
    if c is None:
        yield
        return
    prev = getattr(c, attr)
    setattr(c, attr, value)
    try:
        yield
    finally:
        setattr(c, attr, prev)


def device(d: int):
    """Attribute the work under it to mesh device ``d`` (flat index)."""
    return _scoped("_dev", d)


def pod(p: int):
    """Attribute the work under it to pod ``p``."""
    return _scoped("_pod", p)


def replicated():
    """Work every device does whole (the optimizer update)."""
    return _scoped("_repl", True)


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """One call of kernel ``name`` at the given cost; the ops under it (the
    wrapper's own) are not counted, their outputs are tracked."""
    c = active()
    if c is None:
        yield
        return
    c.calls[name] += 1
    c.op_bytes[f"kernel:{name}"] += nbytes
    c._add(flops, nbytes)
    c._quiet += 1
    try:
        yield
    finally:
        c._quiet -= 1


def collective(kind: str, nbytes: float, *, closed_form: bool = False,
               across_pods: bool = False, pod=None, device=None):
    """``nbytes`` moved by a collective of ``kind`` at the current place
    (or from pod ``pod`` / mesh device ``device``); ``across_pods``: they
    cross from one pod (node) to another."""
    c = active()
    if c is None or c._quiet:
        return
    if kind not in COLLECTIVES:
        raise ValueError(f"collective kind {kind!r} not in {COLLECTIVES}")
    place = (c._pod if pod is None else pod,
             c._dev if device is None else device, c._repl)
    c._coll[kind][place] += nbytes
    if across_pods:
        c._dcn[kind][place] += nbytes
    if closed_form:
        c.closed_form.add(kind)


def gradient_allreduce(grads) -> None:
    """The gradient all-reduce over the counter's ``grad_ranks`` devices in
    closed form: a ring moves 2 (D - 1) / D x the gradient bytes through
    each of the D devices, across pods where its ranks span them (the
    FedAvg baseline's). Each device holds the whole result, so it is
    replicated work."""
    c = active()
    if c is None or c.grad_ranks <= 1:
        return
    d = c.grad_ranks
    n = sum(_nbytes(t) for t in _tensors(grads))
    with replicated():
        collective("all-reduce", 2 * (d - 1) / d * n, closed_form=True,
                   across_pods=c.grad_across_pods)
