"""Expert parallelism (``repro_torch.models.moe_eplocal``) against the
reference's ``moe_eplocal`` on a (4, 2) ("data", "model") mesh.

The reference's ``shard_map`` needs 8 devices, so it runs once for the
whole module in a forced-8-device JAX subprocess (``test_distributed.
run_py``), jitted, on inputs this module draws with numpy; the port runs
the same inputs on ``["cpu"] * 8`` beside it, parameters carried across by
``convert``. Cases: the reduced DeepSeekMoE at the default capacity
(pairs drop: the router is skewed toward expert 0), at ``cap_factor=8.0``
(nothing drops), with 8 experts (two local experts a data shard), with the
fp8 dispatch, and the reduced Jamba at B = 1 (the replicated-token path);
the gradient of a fixed projection of y plus aux for the all_to_all and
fp8 cases; the reduced DeepSeekMoE's ``loss_fn`` and its gradient with
``moe_strategy="eplocal"``. Limits (f32): y within 1e-5, aux within 1e-6,
gradients within 1e-4 of their max, the loss within 1e-5; the fp8
quantization's q and scales bit for bit.

Port-only: the capacity identity (the reference's eplocal capacity equals
``moe.grouped_capacity``), the bytes of the two exchanges against their
closed form, and the refusal without a mesh.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import moe_eplocal as jeplocal
from test_distributed import run_py

from repro_torch import sharding
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.core import pods
from repro_torch.kernels import ops
from repro_torch.models import model, moe, moe_eplocal
from torch_threads import one_torch_thread  # noqa: F401

MESH = (4, 2)
# case -> (arch, max_experts, batch, seq, cap_factor, a2a_fp8, grad)
CASES = {
    "drop": ("deepseek-moe-16b", 4, 8, 16, 1.25, False, True),
    "nodrop": ("deepseek-moe-16b", 4, 8, 16, 8.0, False, False),
    "eloc2": ("deepseek-moe-16b", 8, 8, 16, 1.25, False, False),
    "fp8": ("deepseek-moe-16b", 4, 8, 16, 1.25, True, True),
    "replicated": ("jamba-v0.1-52b", 4, 1, 8, 1.25, False, False),
}
LOSS_ARCH, LOSS_BATCH = "deepseek-moe-16b", (4, 16)


def cfgs(arch, max_experts=4):
    return (jreduced(jget_config(arch), max_experts=max_experts),
            reduced(get_config(arch), max_experts=max_experts))


def case_inputs(name):
    """(moe params, x, projection) of a case, numpy f32: the reference's
    init perturbed by noise, the router skewed toward expert 0 so that
    pairs overflow its capacity."""
    arch, me, b, s, *_ = CASES[name]
    jcfg, _ = cfgs(arch, me)
    seed = sorted(CASES).index(name)
    bld = jlayers.Builder(jax.random.PRNGKey(seed), jnp.float32)
    jmoe.init_moe(bld, jcfg)
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape))
              .astype(np.float32) for k, v in bld.params.items()}
    params["router"][:, 0] += 4.0 / jcfg.d_model
    x = (rng.normal(size=(b, s, jcfg.d_model)) + 0.5).astype(np.float32)
    proj = rng.normal(size=x.shape).astype(np.float32)
    return params, x, proj


def loss_inputs():
    """(flat model params, tokens, labels) of the whole-model case."""
    jcfg, _ = cfgs(LOSS_ARCH)
    tree = jmodel.init_params(jax.random.PRNGKey(5), jcfg)
    flat = {"/".join(str(p.key) for p in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, LOSS_BATCH).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, LOSS_BATCH).astype(np.int32)
    labs[0, -3:] = -1
    return flat, toks, labs


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


REF_CODE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.config import reduced
from repro.configs import get_config
from repro.models.model import loss_fn
from repro.models.moe_eplocal import moe_eplocal
from repro.sharding import logical_rules
spec = json.loads(sys.argv[1])
# Auto axes, as the reference's CI pin (jax 0.4.37) makes them: this jax
# defaults to Explicit ones, under which the whole model's einsums refuse
# the moe's data-sharded output
mesh = jax.make_mesh(tuple(spec["mesh"]), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
with mesh, logical_rules(mesh, {}):
    for name, (arch, me, b, s, cf, fp8, grad) in spec["cases"].items():
        cfg = reduced(get_config(arch), max_experts=me)
        z = np.load(spec["dir"] + "/" + name + ".npz")
        p = {k[2:]: jnp.asarray(z[k]) for k in z.files if k[:2] == "p_"}
        x, proj = jnp.asarray(z["x"]), jnp.asarray(z["proj"])
        fn = lambda p, xx: moe_eplocal(p, cfg, xx, cap_factor=cf,
                                       a2a_fp8=fp8)
        y, aux = jax.jit(fn)(p, x)
        out[name + "/y"], out[name + "/aux"] = np.asarray(y), np.asarray(aux)
        if grad:
            def obj(p, xx):
                y, aux = fn(p, xx)
                return jnp.sum(y * proj) + aux
            gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(p, x)
            out[name + "/gx"] = np.asarray(gx)
            for k, v in gp.items():
                out[name + "/gp/" + k] = np.asarray(v)
    cfg = reduced(get_config(spec["loss_arch"]))
    z = np.load(spec["dir"] + "/loss.npz")
    flat = {k[2:]: jnp.asarray(z[k]) for k in z.files if k[:2] == "p_"}
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    batch = {"tokens": jnp.asarray(z["tokens"]),
             "labels": jnp.asarray(z["labels"])}
    lossf = lambda p: loss_fn(p, cfg, batch, moe_strategy="eplocal")[0]
    loss, g = jax.jit(jax.value_and_grad(lossf))(tree)
    out["loss/loss"] = np.asarray(loss)
    for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out["loss/g/" + "/".join(str(q.key) for q in path)] = np.asarray(v)
np.savez(spec["out"], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference outputs, from one forced-8-device JAX
    subprocess."""
    d = tmp_path_factory.mktemp("eplocal")
    for name in CASES:
        params, x, proj = case_inputs(name)
        np.savez(d / f"{name}.npz", x=x, proj=proj,
                 **{f"p_{k}": v for k, v in params.items()})
    flat, toks, labs = loss_inputs()
    np.savez(d / "loss.npz", tokens=toks, labels=labs,
             **{f"p_{k}": v for k, v in flat.items()})
    spec = {"mesh": MESH, "cases": CASES, "dir": str(d),
            "loss_arch": LOSS_ARCH, "out": str(d / "out.npz")}
    code = ("import sys; sys.argv = ['ref', %r]\n" % json.dumps(spec)
            + REF_CODE)
    assert "ok" in run_py(code)
    return dict(np.load(d / "out.npz"))


def cpu_mesh(shape=MESH):
    return sharding.make_mesh(shape, ("data", "model"),
                              ["cpu"] * int(np.prod(shape)))


def port_case(name, grad=False):
    """The port's (y, aux[, grads of the params, grad of x]) of a case."""
    arch, me, _, _, cf, fp8, _ = CASES[name]
    _, cfg = cfgs(arch, me)
    params, x, proj = case_inputs(name)
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=grad)
    with sharding.logical_rules(cpu_mesh(), {}):
        y, aux = moe_eplocal.moe_eplocal(tp, cfg, tx, cap_factor=cf,
                                         a2a_fp8=fp8)
    if not grad:
        return y, aux
    obj = torch.sum(y * torch.tensor(proj)) + aux
    grads = torch.autograd.grad(obj, [*tp.values(), tx])
    return y, aux, dict(zip(tp, grads[:-1])), grads[-1]


def assert_grad_close(got, want, name):
    """Within 1e-4 of the reference gradient's largest magnitude."""
    got = got.detach().numpy()
    lim = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, name
    assert float(np.abs(got - want).max()) <= lim, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_eplocal_matches_the_references(reference, name):
    grad = CASES[name][-1]
    got = port_case(name, grad)
    y, aux = got[:2]
    np.testing.assert_allclose(y.detach().numpy(), reference[f"{name}/y"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()),
                               float(reference[f"{name}/aux"]),
                               rtol=0, atol=1e-6)
    if grad:
        gp, gx = got[2:]
        assert_grad_close(gx, reference[f"{name}/gx"], "x")
        for k, g in gp.items():
            assert_grad_close(g, reference[f"{name}/gp/{k}"], k)


def test_the_cases_exercise_their_paths():
    """The default capacity drops pairs and 8.0 drops none; the 8-expert
    case has two local experts a data shard; the Jamba case's batch does
    not divide over the data axis (the replicated path)."""
    for name, dropped in (("drop", True), ("nodrop", False)):
        arch, me, b, s, cf, *_ = CASES[name]
        _, cfg = cfgs(arch, me)
        params, x, _ = case_inputs(name)
        t = b // MESH[0] * s
        cap = moe.grouped_capacity(t, cfg.moe.num_experts, cfg.moe.top_k, cf)
        drops = 0
        for i in range(MESH[0]):
            xf = torch.tensor(x[i * (b // MESH[0]):(i + 1) * (b // MESH[0])])
            logits = moe.router_logits(
                {"router": torch.tensor(params["router"])},
                xf.reshape(t, -1))
            slot = ops.moe_route_slots(logits, cfg.moe.top_k, cap)[2]
            drops += int((slot == cap).sum())
        assert (drops > 0) == dropped, (name, drops)
    assert cfgs(*CASES["eloc2"][:2])[1].moe.num_experts // MESH[0] == 2
    assert CASES["replicated"][2] % MESH[0]


def test_fp8_quantization_bit_for_bit():
    """``_quantize_fp8`` on the fp8 case's first send buffer (empty slots
    included) and on a bf16 buffer: q and the bf16 scales equal the
    reference's bit for bit."""
    arch, me, b, s, cf, *_ = CASES["fp8"]
    _, cfg = cfgs(arch, me)
    params, x, _ = case_inputs("fp8")
    t, e, k = b // MESH[0] * s, cfg.moe.num_experts, cfg.moe.top_k
    cap = moe.grouped_capacity(t, e, k, cf)
    xf = torch.tensor(x[:b // MESH[0]]).reshape(t, -1)
    src = ops.moe_route_slots(moe.router_logits(
        {"router": torch.tensor(params["router"])}, xf), k, cap)[3]
    send = F.pad(xf, (0, 0, 0, 1)).index_select(0, src).view(
        MESH[0], e // MESH[0], cap, -1)
    assert bool((send == 0).all(dim=-1).any())          # empty slots
    rng = np.random.default_rng(3)
    bf = torch.tensor(rng.normal(size=(4, 8, 64)) * 10.0 ** rng.integers(
        -3, 3, (4, 8, 1))).to(torch.bfloat16)
    bf[1, 2] = 0
    for buf in (send, bf):
        q, scale = moe_eplocal._quantize_fp8(buf)
        jin = jnp.asarray(buf.float().numpy()).astype(
            jnp.bfloat16 if buf.dtype == torch.bfloat16 else jnp.float32)
        jq, jscale = jeplocal._quantize_fp8(jin)
        assert q.dtype == torch.float8_e4m3fn and scale.dtype == \
            torch.bfloat16
        assert np.array_equal(q.view(torch.uint8).numpy(),
                              np.asarray(jq).view(np.uint8))
        assert np.array_equal(scale.view(torch.int16).numpy(),
                              np.asarray(jscale).view(np.int16))
        back = moe_eplocal._dequantize_fp8(q, scale, torch.float32)
        jback = jeplocal._dequantize_fp8(jq, jscale, jnp.float32)
        assert np.array_equal(back.numpy(), np.asarray(jback))


def test_loss_fn_and_gradient_through_eplocal(reference):
    """The reduced DeepSeekMoE's loss and its gradient with
    ``moe_strategy="eplocal"`` on the mesh."""
    flat, toks, labs = loss_inputs()
    _, cfg = cfgs(LOSS_ARCH)
    params = model_params_from_jax(unflatten(flat), "cpu")
    leaves = {k: v.requires_grad_() for k, v in pods.flatten(params).items()}
    batch = {"tokens": torch.tensor(toks).long(),
             "labels": torch.tensor(labs).long()}
    with sharding.logical_rules(cpu_mesh(), {}):
        loss, _ = model.loss_fn(pods.rebuild(params, leaves), cfg, batch,
                                moe_strategy="eplocal")
    np.testing.assert_allclose(float(loss), float(reference["loss/loss"]),
                               rtol=0, atol=1e-5)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    for (k, v), g in zip(leaves.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        assert_grad_close(g, reference[f"loss/g/{k}"], k)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 2), (64, 6),
                                 (160, 6), (384, 8)])
def test_eplocal_capacity_equals_grouped_capacity(e, k):
    """The reference's eplocal capacity, max(int(cf k T / E), 4) rounded
    up to 8 (ref moe_eplocal.py:93-94), equals ``moe.grouped_capacity``
    (at least 1, rounded up to 8): both floor at 8."""
    for t in (1, 2, 3, 7, 8, 16, 31, 64, 100, 512, 1000, 4096):
        for cf in (0.01, 0.5, 1.0, 1.25, 2.0, 8.0):
            cap = max(int(cf * k * t / e), 4)
            assert moe.grouped_capacity(t, e, k, cf) == (cap + 7) // 8 * 8


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exchange_bytes_equal_the_closed_form(shape, dtype):
    """Bytes moved between data shards: the dispatch into every device, the
    send buffer's bytes x (ep - 1) / ep each (fp8: one byte an element and
    a bf16 scale a row, about half of bf16's for D >= 64), the combine into
    each data shard once, in x's dtype."""
    ep, tp = shape
    _, cfg = cfgs("deepseek-moe-16b", 8)
    params, x, _ = case_inputs("eloc2")
    tparams = {k: torch.tensor(v).to(dtype) for k, v in params.items()}
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = moe.grouped_capacity(b // ep * s, e, k)
    size = torch.tensor([], dtype=dtype).element_size()
    rows = e * cap                     # one data shard's send buffer rows
    got = {}
    for fp8 in (False, True):
        moe_eplocal.reset_exchange()
        with sharding.logical_rules(cpu_mesh(shape), {}):
            moe_eplocal.moe_eplocal(tparams, cfg, torch.tensor(x).to(dtype),
                                    a2a_fp8=fp8)
        got[fp8] = dict(moe_eplocal.EXCHANGE)
        row = d + 2 if fp8 else d * size
        assert got[fp8] == {
            "dispatch": ep * tp * rows * row * (ep - 1) // ep,
            "combine": ep * rows * d * size * (ep - 1) // ep}
    if ep > 1:
        ratio = got[True]["dispatch"] / got[False]["dispatch"]
        assert ratio == pytest.approx((d + 2) / (d * size))
        if dtype == torch.bfloat16:
            assert ratio < 0.52


def test_eplocal_without_a_mesh_raises_the_references_message():
    _, cfg = cfgs("deepseek-moe-16b")
    params, x, _ = case_inputs("drop")
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    for strategy in ("eplocal", "eplocal_fp8"):
        with pytest.raises(AssertionError,
                           match="moe_eplocal requires a mesh context"):
            moe.moe_ffn(tparams, cfg, torch.tensor(x), strategy=strategy)
