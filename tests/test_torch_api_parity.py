"""Plug and play: every public name of a ``repro`` module (re-exports
included; the six Pallas kernel files and ``compat`` aside) resolves in the
``repro_torch`` module with the same path, or stands in
``repro_torch.not_ported.NOT_PORTED`` with its reason, and every entry
there names something the reference has and the port lacks. ROADMAP's
"Not to port" lists the same entries. The stand-alone DTS step
(``core.dts.update_confidence``, ``dts_step``, ``init_dts_state``) is held
against live JAX, and one round of ``core.defta.build_round_fn`` against
the first round ``run_defta`` runs.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dts as jdts

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import defta, dts, fedavg
from repro_torch.core.engine import init_state
from repro_torch.core.tasks import mlp_task
from repro_torch.core.topology import make_topology
from repro_torch.data import federated_dataset
from repro_torch.not_ported import NOT_PORTED
from repro_torch.rng import TorchDraws
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SKIP = {f"repro.kernels.{n}" for n in (
    "gossip_mix", "gossip_mix_sparse", "gossip_mix_quant", "flash_attention",
    "moe_router", "ssd_chunk")} | {"repro.compat"}

# Lists each reference module's public names in a fresh interpreter: the
# reference's dry run sets XLA_FLAGS when it is imported, which must not
# reach this process's JAX. A name bound to an object of another package
# (numpy, jax, typing, __future__) is not the reference's own; a module
# is listed by its own name.
_LIST = r"""
import importlib, json, pkgutil, sys, types
import repro
skip = set(sys.argv[1].split(","))
out = {}
for info in pkgutil.walk_packages(repro.__path__, "repro."):
    if info.name in skip:
        continue
    mod = importlib.import_module(info.name)
    names = getattr(mod, "__all__", None) or [
        n for n in vars(mod) if not n.startswith("_")]
    kept = {}
    for n in names:
        obj = getattr(mod, n)
        if isinstance(obj, types.ModuleType):
            if obj.__name__.startswith("repro.") and obj.__name__ not in skip:
                kept[n] = obj.__name__
            continue
        where = getattr(obj, "__module__", None)
        if isinstance(where, str) and not where.startswith("repro"):
            continue
        kept[n] = None
    out[info.name] = kept
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_names():
    """{module: {name: the module it names, or None}} of the reference."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _LIST, ",".join(SKIP)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def _resolves(module: str, name: str, target) -> bool:
    """``name`` of reference ``module`` at the port's same path: an
    attribute of the port's module, or (a submodule) the port's module of
    the same name."""
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    if hasattr(port, name):
        return True
    return target == f"{module}.{name}" and importlib.util.find_spec(
        "repro_torch" + target[len("repro"):]) is not None


def _missing(reference_names) -> set:
    return {f"{m[len('repro.'):]}.{n}"
            for m, names in reference_names.items()
            for n, target in names.items() if not _resolves(m, n, target)}


def test_every_public_name_resolves_or_is_not_ported(reference_names):
    assert len(reference_names) > 50 and not SKIP & set(reference_names)
    unexplained = _missing(reference_names) - set(NOT_PORTED)
    assert not unexplained, sorted(unexplained)


def test_not_ported_entries_are_in_the_reference_and_absent_here(
        reference_names):
    listed = {f"{m[len('repro.'):]}.{n}" for m, names in
              reference_names.items() for n in names}
    assert set(NOT_PORTED) <= listed, sorted(set(NOT_PORTED) - listed)
    assert set(NOT_PORTED) <= _missing(reference_names)
    for key, why in NOT_PORTED.items():
        assert why.strip() and "\n" not in why, key


def test_roadmap_not_to_port_mirrors_the_table():
    text = (ROOT / "ROADMAP.md").read_text()
    block = text.split("Not to port:", 1)[1].split("\n\n", 1)[0]
    names = set(re.findall(r"^  - `([\w.]+)`", block, flags=re.M))
    assert names == set(NOT_PORTED)


def test_wire_bytes_is_one_table():
    """``core.gossip`` owns the wire table, as in the reference, and
    ``launch.roofline`` adds the config spellings to it."""
    from repro.core import gossip as jgossip

    from repro_torch.core import gossip
    from repro_torch.launch import roofline
    assert gossip.WIRE_BYTES == jgossip.WIRE_BYTES
    assert roofline.WIRE_BYTES == {**gossip.WIRE_BYTES, "float32": 4,
                                   "bfloat16": 2}


def test_sparse_support_counts_its_memo():
    from repro_torch.core import gossip
    adj = make_topology("ring", 7, 2, 3)
    gossip.sparse_support(adj)
    before = dict(gossip.SUPPORT_CACHE_STATS)
    gossip.sparse_support(adj.copy())
    gossip.sparse_support(~adj)
    assert gossip.SUPPORT_CACHE_STATS["hits"] == before["hits"] + 1
    assert gossip.SUPPORT_CACHE_STATS["misses"] >= before["misses"] + 1


# ---------------------------------------------------------------------------
# The stand-alone DTS step against live JAX
# ---------------------------------------------------------------------------

# one worker's losses over six steps: a first loss, a gain, a loss, an
# explosion (damaged), a NaN (damaged) and a recovery
LOSSES = [2.0, 1.5, 1.8, 500.0, float("nan"), 1.2]


@pytest.mark.parametrize("w,seed", [(5, 0), (12, 1)])
def test_dts_step_matches_jax(w, seed):
    rng = np.random.default_rng(seed)
    jst = jdts.init_dts_state(w)
    st = dts.init_dts_state(w, device="cpu")
    for loss in LOSSES:
        mask = (rng.random(w) < 0.5).astype(np.float32)
        p = rng.dirichlet(np.ones(w)).astype(np.float32)
        jst, jdam, jlt = jdts.dts_step(jst, jnp.float32(loss),
                                       jnp.asarray(mask), jnp.asarray(p))
        st, dam, lt = dts.dts_step(st, loss, torch.tensor(mask),
                                   torch.tensor(p))
        assert bool(dam) == bool(jdam)
        np.testing.assert_allclose(float(lt), float(jlt), rtol=1e-6)
        for k in ("conf", "best_loss", "last_loss"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    conf = rng.normal(size=w).astype(np.float32)
    args = [rng.random(w).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(
        dts.update_confidence(torch.tensor(conf), *map(torch.tensor, args),
                              0.7).numpy(),
        np.asarray(jdts.update_confidence(conf, *args, 0.7)), rtol=1e-6,
        atol=1e-6)


# ---------------------------------------------------------------------------
# build_round_fn is the round run_defta drives
# ---------------------------------------------------------------------------

def test_build_round_fn_is_the_first_round_of_run_defta():
    cfg = DeFTAConfig(num_workers=4, avg_peers=2, num_sampled=1,
                      local_epochs=1)
    train = TrainConfig(batch_size=16)
    task = mlp_task(32, 10)
    data = federated_dataset("vector", 4, np.random.default_rng(0),
                             n_per_worker=32)
    want, adj, malicious, _ = defta.run_defta(
        3, task, cfg, train, data, epochs=1, num_malicious=1,
        gossip_backend="einsum", device="cpu")
    w, mal, padded, sizes = defta.attacker_world(cfg, data, 1)
    assert np.array_equal(mal, malicious)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    state = init_state(gen, task, w)
    rnd = defta.build_round_fn(task, cfg, train, adj, sizes, mal,
                               draws=TorchDraws(gen), device="cpu")
    got = rnd(state, defta.to_device_data(padded, "cpu"))
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    assert torch.equal(got.conf, want.conf)
    assert torch.equal(got.epoch, want.epoch)
