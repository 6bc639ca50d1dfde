"""Tensor parallelism inside a pod (``repro_torch.sharding``'s placement,
``launch.sharding_rules``, ``launch.steps``) against the reference's
logical-axis resolution, on the CPU.

* Specs: for the eleven full configs, the port's ``resolve_spec`` /
  ``sharding_tree`` of ``param_axes``, ``cache_axes``, the Adam and
  Adafactor states (``_opt_state_axes``, ``zero1_axes`` under the zero1
  variant) equal the reference's on an ``AbstractMesh`` of (2, 2), (2, 4)
  and (2, 2, 2) (the reference's ``resolve_spec`` reads only
  ``mesh.shape``: no device, no compile), and each demotion warns once.
* Bytes: a device's placed parameter bytes at (2, 4) equal the
  reference's specs' (Mamba2-780M and Jamba above them by the mixer's
  per-head layout, ``models.ssm``'s closed form).
* Collectives: the tensor-parallel bytes a meta prefill counts equal
  ``counting``'s closed form.
* The launcher: ``--debug-mesh --smoke`` losses against the reference
  launcher's, run with Auto mesh axes in one subprocess.

Tensor-parallel numerics against the reference are in
``test_torch_tp_models.py`` and ``test_torch_tp_mixers.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsharding
from repro.configs import get_config as jget_config
from repro.launch import sharding_rules as jrules
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake

from repro_torch import counting, sharding
from repro_torch.config import ShapeConfig, SHAPES, reduced
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding_rules, steps
from repro_torch.models import model
from repro_torch.models import ssm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = {(2, 2): ("data", "model"), (2, 4): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _is_axes(v):
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def _flat_axes(tree, prefix=""):
    if _is_axes(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_axes(v, f"{prefix}/{k}"))
    return out


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """The reference's param axes and shapes, its cache axes and shapes at
    decode_32k, and its optimizer-state shapes."""
    cfg = jget_config(arch)
    axes = jmodel.param_axes(cfg)
    sds = jmodel.abstract_params(cfg)
    shape = SHAPES["decode_32k"]
    cache = jax.eval_shape(lambda: jmodel.init_cache(
        cfg, shape.global_batch, shape.seq_len))
    opt = {n: jax.eval_shape(jmake(n, 1e-3).init, sds)
           for n in ("adam", "adafactor")}
    return cfg, axes, sds, jmodel.cache_axes(cfg), cache, opt


def _ref_specs(mesh_shape, rules, axes, sds):
    amesh = AbstractMesh(mesh_shape, MESHES[mesh_shape])
    fa, fs = _flat_axes(axes), _flat(sds)
    out = {}
    with jsharding.logical_rules(amesh, rules):
        for k, a in fa.items():
            out[k] = tuple(jsharding.resolve_spec(a, fs[k].shape))
    return out


def _port_specs(mesh, rules, axes, shapes):
    tree = sharding_rules.sharding_tree(mesh, rules, axes, shapes)
    return {k: v.spec for k, v in _flat(tree).items()}


def _mesh(shape):
    return sharding.make_mesh(shape, MESHES[shape],
                              ["meta"] * int(np.prod(shape)))


FULL = [a for a in ARCH_IDS]


@pytest.mark.parametrize("variant", ["baseline", "zero1"])
@pytest.mark.parametrize("mesh_shape", sorted(MESHES))
def test_specs_equal_the_references(mesh_shape, variant):
    """Every leaf of the eleven full configs' parameters, Adam and
    Adafactor states and decode caches resolves to the reference's spec;
    the logical-axes trees are the reference's."""
    multi = len(mesh_shape) == 3
    rules = sharding_rules.base_rules(multi, variant=variant)
    assert rules == jrules.base_rules(multi, variant=variant)
    mesh = _mesh(mesh_shape)
    assert len(FULL) == 11
    for arch in FULL:
        jcfg, jaxes, jsds, jcaxes, jcache, jopt = _ref(arch)
        cfg = get_config(arch)
        axes = model.param_axes(cfg)
        assert _flat_axes(axes) == _flat_axes(jaxes), arch
        shapes = model.abstract_params(cfg)
        assert _port_specs(mesh, rules, axes, shapes) == \
            _ref_specs(mesh_shape, rules, jaxes, jsds), arch
        assert _flat_axes(model.cache_axes(cfg)) == _flat_axes(jcaxes)
        shape = SHAPES["decode_32k"]
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
        assert _port_specs(mesh, rules, model.cache_axes(cfg), cache) == \
            _ref_specs(mesh_shape, rules, jcaxes, jcache), arch
        for name in ("adam", "adafactor"):
            jo = jsteps._opt_state_axes(name, jaxes, jsds)
            po = steps._opt_state_axes(name, axes, shapes)
            if rules.get("zero"):
                jo = jrules.zero1_axes(jo, jopt[name], rules)
                from repro_torch.optim import make_optimizer
                po = sharding_rules.zero1_axes(
                    po, make_optimizer(name, 1e-3).init(shapes), rules)
            assert _flat_axes(po) == _flat_axes(jo), (arch, name)
            assert _port_specs(mesh, rules, po, _opt_shapes(name, shapes)) \
                == _ref_specs(mesh_shape, rules, jo, jopt[name]), \
                (arch, name)


@functools.lru_cache(maxsize=None)
def _opt_init(name):
    from repro_torch.optim import make_optimizer
    return make_optimizer(name, 1e-3)


def _opt_shapes(name, shapes):
    return _opt_init(name).init(shapes)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_decode_input_specs_place_the_cache_as_the_references(mesh_shape):
    """``steps.input_specs`` with a mesh places the decode cache of each
    full config by the shardings the reference's ``input_specs`` attaches
    on an ``AbstractMesh`` (granite-20b's one kv head puts head_dim on the
    model axis); the batch's data axis is named, not cut."""
    from repro.launch.steps import input_specs as jinput_specs
    rules = sharding_rules.base_rules(False)
    mesh = _mesh(mesh_shape)
    amesh = AbstractMesh(mesh_shape, MESHES[mesh_shape])
    shape = SHAPES["decode_32k"]
    for arch in FULL:
        want = jinput_specs(jget_config(arch), shape, amesh, rules)["cache"]
        want = {k: tuple(v.sharding.spec) for k, v in _flat(want).items()}
        specs = steps.input_specs(get_config(arch), shape, mesh, rules)
        got = {k: v.spec for k, v in _flat(specs["cache"]).items()}
        assert got == want, arch
        for p in _flat(specs["cache"]).values():
            assert all(t.shape[0] == p.shape[0] for t in p.parts)
    g = _flat(steps.input_specs(get_config("granite-20b"), shape, mesh,
                                rules)["cache"])
    k = next(v for n, v in g.items() if n.endswith("/k"))
    tp = mesh_shape[1]
    assert k.spec[-1] == "model" and k.parts[0].shape[-1] == 128 // tp


def test_each_demotion_warns_once():
    """The port warns each (logical name, mesh axis, dim) once, the same
    set the reference warns."""
    rules = sharding_rules.base_rules(False)
    mesh = _mesh((2, 4))
    amesh = AbstractMesh((2, 4), ("data", "model"))
    sharding._DEMOTION_WARNED.clear()
    jsharding._DEMOTION_WARNED.clear()
    for arch in ("whisper-tiny", "granite-3-2b", "granite-20b"):
        jcfg, jaxes, jsds, *_ = _ref(arch)
        cfg = get_config(arch)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(2):
                _port_specs(mesh, rules, model.param_axes(cfg),
                            model.abstract_params(cfg))
        texts = [str(w.message) for w in rec
                 if "demoting" in str(w.message)]
        with warnings.catch_warnings(record=True) as jrec:
            warnings.simplefilter("always")
            fa, fs = _flat_axes(jaxes), _flat(jsds)
            with jsharding.logical_rules(amesh, rules):
                for k, a in fa.items():
                    jsharding.resolve_spec(a, fs[k].shape)
        jtexts = [str(w.message) for w in jrec
                  if "demoting" in str(w.message)]
        assert len(texts) == len(set(texts)) and sorted(texts) == \
            sorted(jtexts), arch
    # whisper's 6 heads and 51,865 words, granite-3-2b's 49,155 words
    assert ("heads", ("model",), 6) in sharding._DEMOTION_WARNED
    assert ("vocab", ("model",), 51865) in sharding._DEMOTION_WARNED
    assert ("vocab", ("model",), 49155) in sharding._DEMOTION_WARNED


# parameters only: a device's GB at (2, 4) by the reference's specs
PER_DEVICE_GB = {"qwen2.5-32b": 16.38, "granite-20b": 10.16,
                 "jamba-v0.1-52b": 14.46, "deepseek-moe-16b": 4.46,
                 "granite-3-2b": 1.42, "qwen3-0.6b": 0.30,
                 "mamba2-780m": 0.39, "kimi-k2-1t-a32b": 260.22}


def _ssm_extra(cfg, tp):
    """The mixer layout's extra elements a device a mamba layer:
    2 d_state (1 - 1/tp) (d_model + d_conv + 1) (in_proj, conv_w,
    conv_b)."""
    s = cfg.ssm
    return 2 * s.d_state * (1 - 1 / tp) * (cfg.d_model + s.d_conv + 1)


@pytest.mark.parametrize("arch", sorted(PER_DEVICE_GB))
def test_placed_parameter_bytes_a_device(arch):
    jcfg, jaxes, jsds, *_ = _ref(arch)
    rules = sharding_rules.base_rules(False)
    specs = _ref_specs((2, 4), rules, jaxes, jsds)
    sizes = {"data": 2, "model": 4}
    itemsize = 2                                  # bf16 in every config
    want = 0
    for k, sds in _flat(jsds).items():
        n = int(np.prod(sds.shape))
        for e in specs[k]:
            for a in sharding.axes_of(e):
                n //= sizes[a]
        want += n * itemsize
    assert round(want / 1e9, 2) == PER_DEVICE_GB[arch]
    cfg = get_config(arch)
    placed = model.place_params(model.abstract_params(cfg), cfg,
                                _mesh((2, 4)), rules)
    leaves = [p for _, p in sharding.placed_leaves(placed)]
    coords = leaves[0].owners
    per = [sum(p.device_bytes(c) for p in leaves) for c in coords]
    got = max(per)
    mamba = sum(k in ("mamba", "mamba_moe") for k in cfg.block_schedule())
    extra = mamba * _ssm_extra(cfg, 4) * itemsize if cfg.ssm else 0
    assert got - want == pytest.approx(extra, abs=1e-6)
    if arch == "mamba2-780m":
        # the docstring's 0.59 MB a layer of in_proj
        s = cfg.ssm
        assert round(2 * s.d_state * 0.75 * cfg.d_model * 2 / 1e6, 2) == 0.59


def test_mixer_layout_groups_cover_the_columns_once():
    """The per-head groups and the shared B, C columns partition in_proj's
    and the conv's columns, and a device's block is the reference's
    contiguous block plus 2 d_state (1 - 1/tp) columns."""
    cfg = reduced(get_config("mamba2-780m"))
    for tp in (2, 4):
        for which, width in (("in_proj", 2 * 512 + 32 + 16),
                             ("conv", 512 + 32)):
            groups, shared = ssm.head_layout(cfg, which, tp)
            cols = torch.cat(groups + [shared]).sort().values
            assert torch.equal(cols, torch.arange(width))
            assert len(groups[0]) + len(shared) - width / tp == \
                pytest.approx(2 * cfg.ssm.d_state * (1 - 1 / tp))


def _count_prefill(cfg, rules, b, s, tp=4):
    mesh = sharding.make_mesh((2, tp), ("data", "model"), ["meta"] * 2 * tp)
    params = model.place_params(model.abstract_params(cfg), cfg, mesh,
                                rules)
    tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
    with sharding.logical_rules(mesh, rules), \
            counting.Counter(split=2, tp=tp, devices=2 * tp) as c:
        model.forward(params, cfg, {"tokens": tokens})
    return c


@pytest.mark.parametrize("variant", ["baseline", "no_seqshard"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-20b"])
def test_tensor_parallel_collectives_are_the_closed_form(arch, variant):
    """A meta prefill's tensor-parallel collective bytes a device equal
    ``counting``'s closed form: under sequence parallelism an all-gather
    and a reduce-scatter of A = B S D b around each branch, without it an
    all-reduce of 2 (tp - 1) / tp A; the embedding's reduce (vocab-
    parallel), the final all-gather of x, the logits' gather; granite-20b
    gathers k and v along head_dim (one kv head)."""
    cfg = dataclasses.replace(reduced(get_config(arch), num_layers=3,
                                      d_model=256),
                              dtype="bfloat16", vocab_size=1024)
    b, s, tp, split = 4, 64, 4, 2
    rules = sharding_rules.base_rules(False, variant=variant)
    c = _count_prefill(cfg, rules, b, s, tp)
    got = c.collectives()
    a = b * s * cfg.d_model * 2
    f = (tp - 1) / tp
    branches = 2 * cfg.num_layers
    want = {k: 0.0 for k in counting.COLLECTIVES}
    if variant == "baseline":
        want["reduce-scatter"] = (branches + 1) * f * a
        want["all-gather"] = (branches + 1) * f * a
    else:
        want["all-reduce"] = (branches + 1) * 2 * f * a
    want["all-gather"] += f * b * s * cfg.vocab_size * 2   # the logits
    if cfg.num_kv_heads % tp:
        kv = b * s * cfg.num_kv_heads * cfg.head_dim * 2
        want["all-gather"] += cfg.num_layers * 2 * f * kv
    want = {k: v / split for k, v in want.items()}
    assert got == pytest.approx(want, rel=1e-12)


REF_LAUNCH = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
_make = jax.make_mesh
def make_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make(shape, names, **kw)
jax.make_mesh = make_mesh
import contextlib, io
from repro.launch import train
out = {}
for arch in sys.argv[1:]:
    sys.argv = ["train", "--arch", arch, "--smoke", "--debug-mesh",
                "--steps", "2", "--batch", "4", "--seq", "32"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main()
    out[arch] = buf.getvalue()
print("RESULT " + json.dumps(out))
"""


def test_debug_mesh_smoke_losses_match_the_reference_launcher(capsys):
    """``--debug-mesh --smoke`` (a (2, 2) mesh of the CPU repeated; the
    state placed, the steps tensor-parallel) from the reference
    launcher's initial parameters: each step's loss within 1.5e-4 of the
    reference launcher's printed one (its mesh made with Auto axes, as jax
    0.4.37 makes it: this jax's Explicit default refuses its constraints).
    """
    from jax import numpy as jnp  # noqa: F401
    from repro.config import reduced as jreduced
    from test_torch_launch_train import printed_losses

    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch import train

    archs = ["qwen3-0.6b", "mamba2-780m"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_LAUNCH, *archs],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    ref = json.loads(r.stdout.split("RESULT ", 1)[1])
    for arch in archs:
        want = printed_losses(ref[arch])
        tree = jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(0), jreduced(jget_config(arch))))
        args = train.parser().parse_args(
            ["--device", "cpu", "--arch", arch, "--smoke", "--debug-mesh",
             "--steps", "2", "--batch", "4", "--seq", "32"])
        args.argv = []
        got = train.train_lm(args, params=model_params_from_jax(tree, "cpu"))
        capsys.readouterr()
        assert len(want) == len(got["losses"]) == 2
        np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1.5e-4)
        # the state stayed placed on the (2, 2) mesh
        assert sharding.is_placed(got["params"])
        assert got["params"]["embedding"].mesh.shape == {"data": 2,
                                                         "model": 2}


def test_dryrun_variants_change_the_placement():
    """The reference's variants, restored in the dry run: zero1 splits the
    Adam moments over the data axis too (about half a device's state),
    pure_dp replicates every parameter; a device's parameter bytes under
    the baseline are a quarter of the whole (model axis 4)."""
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              dtype="bfloat16")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                seq_len=16)
    got = {}
    for variant in ("baseline", "zero1", "pure_dp"):
        p = dryrun.plan("qwen3-0.6b", shape, config=cfg, variant=variant)
        params, opt_state, _, _ = dryrun.build_state(p)
        got[variant] = (dryrun._device_bytes(params),
                        dryrun._device_bytes(opt_state))
    whole = sum(t.numel() * t.element_size() for t in
                counting._tensors(model.abstract_params(cfg)))
    assert got["pure_dp"][0] == whole
    assert got["baseline"][0] < 0.3 * whole
    assert got["zero1"][0] == got["baseline"][0]
    assert got["zero1"][1] < 0.6 * got["baseline"][1]
