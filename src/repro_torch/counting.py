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
module's hooks (``kernel``, ``collective``, ``device``, ``shard``, ``pod``,
``replicated``), each a no-op without an active counter; it imports
nothing of the port, so every layer of it may.

**A device's share.** The port is single-controller: one process runs the
whole mesh's work. Work is attributed to places: ops inside
``device(d)`` (``moe_eplocal``'s per-device loops, the optimizer's update
of a block; d a flat mesh index i * tp + j, or a tuple of them) to those
devices whole; ops inside ``shard(j)`` (a tensor-parallel model shard's
work, ``sharding.TensorParallel``) to every device of model index j, for
the data axis's share of the batch (over ``split``); ops inside
``replicated()`` to every device whole; ops inside ``pod(p)`` (the FL
step's pod loop) to pod p; and the rest to the batch, which splits over
``split`` devices. An op outside every scope that reads a tensor made
inside one (the backward of a scoped forward) takes that scope: the
device's, else the shard's, where its inputs name only one. A device's
figure is that of the busiest
device: ``split``'s share of the batch's work, plus the replicated work,
plus its own and its model shard's. Live storage is attributed the same
way; storage made outside those scopes is the batch's, except that a
tensor with the shape of a registered whole leaf or of one layer of it (a
gradient, an accumulator) is counted whole (whole on its shard's devices
inside ``shard(j)``). ``track_placed`` registers a placed tree
(``sharding.Placed``) block by block on the devices that hold each block.

**Tensor-parallel collectives** (``sharding.TensorParallel``; tp the model
axis, n a tensor's whole bytes, a ring's traffic through each device):
an all-reduce moves 2 (tp - 1) / tp x n, a reduce-scatter and an
all-gather (tp - 1) / tp x n. Per layer of B x S tokens of width D in
bytes b (activation bytes A = B S D b):

- outside sequence parallelism, and at decode (S = 1), one all-reduce
  after each row-parallel projection (attention's ``wo``, the MLP's
  ``wo``, the mixer's ``out_proj``, the shared experts): 2 (tp - 1) / tp
  x A each, so 4 (tp - 1) / tp x A for a block of two branches;
- under sequence parallelism ("act_seq" -> "model", S divisible by tp)
  an all-gather before and a reduce-scatter after each branch: (tp - 1)
  / tp x A each, the same 4 (tp - 1) / tp x A a block;
- an all-gather of k and v along head_dim where the kv heads do not
  split (granite-20b's one): 2 (tp - 1) / tp x B S Hkv hd b; of q too
  where the heads do not split (whisper's 6 at tp 4);
- the mixer's gated norm all-reduces its sum of squares: 2 (tp - 1) / tp
  x B S x 4 bytes;
- the vocabulary-parallel embedding reduce-scatters (or all-reduces) A
  once; the parallel cross-entropy all-reduces three [B, S] float32
  vectors (max, sum of exponents, target logit).
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
                 grad_across_pods: bool = False, tp: int = 1,
                 devices: int = 0):
        super().__init__()
        self.split = max(int(split), 1)
        self.tp = max(int(tp), 1)
        # the devices of a pod's mesh (default: the batch's times the model
        # axis)
        self.n_devices = int(devices) or self.split * self.tp
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
        self._pod = self._dev = self._shard = None
        self._repl = False
        self._quiet = 0
        self._live: dict = {}                    # storage -> (nbytes, tag)
        # live bytes by pod: whole, the batch's, by mesh device, and by
        # model shard (whole, and the batch's share)
        self._whole: dict = defaultdict(int)
        self._split: dict = defaultdict(int)
        self._on_dev: dict = defaultdict(int)    # (pod, device) -> bytes
        self._sh_whole: dict = defaultdict(int)  # (pod, shard) -> bytes
        self._sh_split: dict = defaultdict(int)
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
        if self._dev is None and self._shard is None and not self._repl:
            inferred = self._infer(ins)
            if inferred is not None:
                prev = (self._dev, self._shard)
                self._dev, self._shard = inferred
                try:
                    return self._dispatch(func, args, kwargs, ins)
                finally:
                    self._dev, self._shard = prev
        return self._dispatch(func, args, kwargs, ins)

    def _infer(self, ins):
        """The scope of a backward op run outside every scope that reads
        tensors made inside one scope: (device, None) where they name one
        device, else (None, shard) where they name one shard, else
        None."""
        if torch._C._current_autograd_node() is None:
            return None
        devs, shards = set(), set()
        for t in ins:
            try:
                tag = self._live.get(t.untyped_storage()._cdata)
            except (RuntimeError, NotImplementedError):
                continue
            if tag is None or not isinstance(tag[1][1], tuple):
                continue
            kind = tag[1][1]
            if kind[0] == "device":
                devs.add(kind[1])
            elif kind[0] in ("shard", "shard_whole"):
                shards.add(kind[1])
        if len(devs) == 1:
            return next(iter(devs)), None
        if not devs and len(shards) == 1:
            return None, next(iter(shards))
        return None

    def _dispatch(self, func, args, kwargs, ins):
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
        return (self._pod, self._dev, self._repl, self._shard)

    def _add(self, flops, nbytes):
        place = self._place()
        self._flops[place] += flops
        self._bytes[place] += nbytes

    # -- live storage ----------------------------------------------------
    def _kind(self, t):
        whole = self._repl or tuple(t.shape) in self._whole_shapes
        if self._dev is not None:
            return ("device", self._dev)
        if self._shard is not None:
            return ("shard_whole" if whole else "shard", self._shard)
        return "whole" if whole else "split"

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
        elif kind[0] == "shard":
            self._sh_split[(pod, kind[1])] += n
        elif kind[0] == "shard_whole":
            self._sh_whole[(pod, kind[1])] += n
        else:                               # "device" or "held": devices
            for d in kind[1]:
                self._on_dev[(pod, d)] += n

    def _release(self, key):
        n, tag = self._live.pop(key, (0, None))
        if tag is not None:
            self._count_live(tag, -n)
            self.live_bytes -= n

    def _device_live(self) -> float:
        """The live bytes of the busiest device now."""
        pods = {p for p in (*self._whole, *self._split)} | \
            {p for p, _ in (*self._on_dev, *self._sh_whole, *self._sh_split)}
        pods = {p for p in pods if p is not None} or {None}
        best = 0.0
        for p in pods:
            shared = p is not None

            def mine(acc):
                out = defaultdict(int)
                for (q, d), n in acc.items():
                    if q == p or (shared and q is None):
                        out[d] += n
                return out
            own, shw, shs = (mine(self._on_dev), mine(self._sh_whole),
                             mine(self._sh_split))
            per = max((own[d] + shw[d % self.tp] + shs[d % self.tp]
                       / self.split for d in set(own) | set(range(
                           self.n_devices))), default=0)
            best = max(best, self._whole[p] + shared * self._whole[None]
                       + (self._split[p] + shared * self._split[None])
                       / self.split + per)
        return best

    def track(self, tree, *, kind: str = "whole", pod=None):
        """Register tensors made before the count (parameters, optimizer
        state: ``kind="whole"``; a batch or a decode cache: ``"split"``)
        as live. A whole leaf's shape, and one layer's, marks later
        tensors of that shape whole (gradients, accumulators)."""
        if kind == "whole":
            self._mark_whole(_tensors(tree))
        self._track(tree, kind=kind, pod=pod)

    def _mark_whole(self, tensors):
        for t in tensors:
            self._whole_shapes.add(tuple(t.shape))
            if t.dim() > 1:
                self._whole_shapes.add(tuple(t.shape[1:]))

    def track_placed(self, leaves, *, batch: bool = False, pod=None):
        """Register placed leaves (``sharding.Placed``; a list of them)
        block by block on the devices holding each block: a parameter's or
        an optimizer state's whole on each holder, a decode cache's
        (``batch``) for the data axis's share, by its model shard."""
        everyone = None
        for p in leaves:
            if not batch:
                self._mark_whole(p.parts)
            for k, part in enumerate(p.parts):
                held = p.holders(k)
                if everyone is None:
                    everyone = len(p.owners)
                if len(held) == everyone:
                    kind = "split" if batch else "whole"
                elif batch:
                    kind = ("shard", held[0] % self.tp)
                else:
                    kind = ("held", held)
                self._track(part, kind=kind, pod=pod)

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
        busiest device's own and its model shard's."""
        def one(p):
            batch = repl = 0.0
            devs, shard = defaultdict(float), defaultdict(float)
            for (q, d, r, s), v in acc.items():
                if q != p:
                    continue
                if d is not None:
                    for x in d:
                        devs[x] += v
                elif s is not None:
                    shard[s] += v if r else v / self.split
                elif r:
                    repl += v
                else:
                    batch += v
            per = max((devs[d] + shard[d % self.tp] for d in
                       set(devs) | set(range(self.n_devices))), default=0)
            return batch / self.split + repl + per
        pods = [one(p) for p in {q for q, _, _, _ in acc if q is not None}]
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
            or not _functional(func) or func.overloadpacket in _NO_TRAFFIC:
        # (``_unsafe_view`` returns a view its schema does not declare: a
        # made output would hold a storage of its own)
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


def device(d):
    """Attribute the work under it to mesh device ``d`` (a flat index, or
    a tuple of them: each does it whole)."""
    return _scoped("_dev", (d,) if isinstance(d, int) else tuple(d))


def shard(j: int):
    """Attribute the work under it to model shard ``j``: each device of
    model index j does the data axis's share of it."""
    return _scoped("_shard", j)


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
    if isinstance(device, int):
        device = (device,)
    place = (c._pod if pod is None else pod,
             c._dev if device is None else device, c._repl, c._shard)
    c._coll[kind][place] += nbytes
    if across_pods:
        c._dcn[kind][place] += nbytes
    if closed_form:
        c.closed_form.add(kind)


def gradient_allreduce(grads, held=None) -> None:
    """The gradient all-reduce over the counter's ``grad_ranks`` devices in
    closed form: a ring moves 2 (D - 1) / D x the gradient bytes through
    each of the D devices, across pods where its ranks span them (the
    FedAvg baseline's). Each device holds the whole result, so it is
    replicated work. ``held`` (a placed step's blocks: a list of (tensor,
    holders)) counts each block at the devices that hold it."""
    c = active()
    if c is None or c.grad_ranks <= 1:
        return
    d = c.grad_ranks
    if held is not None:
        for t, devs in held:
            collective("all-reduce", 2 * (d - 1) / d * _nbytes(t),
                       closed_form=True, across_pods=c.grad_across_pods,
                       device=devs)
        return
    n = sum(_nbytes(t) for t in _tensors(grads))
    with replicated():
        collective("all-reduce", 2 * (d - 1) / d * n, closed_form=True,
                   across_pods=c.grad_across_pods)
