"""The port's telemetry registry, payload pricing and sinks against the
reference's ``repro.telemetry``.

The spec sets are held field for field (names, stages, shapes, dtypes,
docs, declaration order), the frame and buffer bytes and the wire payload
prices equal, the registry's error paths raise the reference's exception
classes, and identical frames give byte-identical JSONL rows through both
ledgers and sinks.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.telemetry as jtm

import repro_torch.telemetry as tm
from repro_torch.core.tasks import mlp_task
from repro_torch.telemetry.spec import TORCH_DTYPES, gather_frames


def fields(specs):
    return [dataclasses.astuple(s) for s in specs]


FLAGS = [dict(), dict(scenario=True), dict(use_ef=True),
         dict(scenario=True, use_ef=True)]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "base")
@pytest.mark.parametrize("w", [1, 8, 60])
def test_defta_and_tick_specs_equal(w, flags):
    assert fields(tm.defta_specs(w, **flags)) == \
        fields(jtm.defta_specs(w, **flags))
    assert fields(tm.tick_specs(w)) == fields(jtm.tick_specs(w))
    assert fields(tm.fedavg_specs(w)) == fields(jtm.fedavg_specs(w))


@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("k", [4, 64])
def test_cross_device_specs_equal(k, use_ef):
    assert fields(tm.cross_device_specs(k, use_ef=use_ef)) == \
        fields(jtm.cross_device_specs(k, use_ef=use_ef))


@pytest.mark.parametrize("kind", ["defta", "tick", "fedavg", "cross_device"])
def test_frame_and_buffer_bytes_equal(kind):
    def specs(m):
        return {"defta": m.defta_specs(22, scenario=True, use_ef=True),
                "tick": m.defta_specs(8) + m.tick_specs(8),
                "fedavg": m.fedavg_specs(22),
                "cross_device": m.cross_device_specs(64, use_ef=True)}[kind]
    ours, theirs = tm.Telemetry(specs(tm)), jtm.Telemetry(specs(jtm))
    assert ours.frame_bytes() == theirs.frame_bytes() == \
        tm.frame_bytes(specs(tm))
    for window in (1, 7, 50):
        assert ours.buffer_bytes(window) == theirs.buffer_bytes(window)
    assert [s.nbytes for s in ours.specs] == [s.nbytes for s in theirs.specs]


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "fp32"])
def test_payload_bytes_equal_on_converted_params(wire):
    """The MLP's stacked params (drawn by the port, carried across to
    JAX arrays) and one un-stacked model: int8 adds 4 bytes a leaf."""
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = mlp_task(32, 10).init(gen, 5)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    assert tm.stacked_payload_bytes(tp, wire) == \
        jtm.stacked_payload_bytes(jp, wire)
    one_j = jax.tree.map(lambda x: x[0], jp)
    one_t = {k: v[0] for k, v in tp.items()}
    assert tm.tree_payload_bytes(one_t, wire) == \
        jtm.tree_payload_bytes(one_j, wire)
    for n, rows in ((2762, 4), (1, 1), (10**6, 7)):
        assert tm.wire_payload_bytes(n, wire, rows) == \
            jtm.wire_payload_bytes(n, wire, rows)
    n = sum(int(np.prod(v.shape[1:])) for v in tp.values())
    extra = 4 * len(tp) if wire == "int8" else 0
    per = {None: 4, "fp32": 4, "bf16": 2, "int8": 1}[wire]
    assert tm.stacked_payload_bytes(tp, wire) == float(n * per + extra)


def registry_errors(m, zeros):
    """The reference test's error paths through package ``m``; returns the
    exception class each raised, in order."""
    got = []
    r = m.Telemetry()
    r.declare(m.MetricSpec("a", "s1", (), "float32"))
    r.declare(m.MetricSpec("a", "s1", (), "float32"))     # equal: no-op
    for fn in (lambda: r.declare(m.MetricSpec("a", "s1", (3,), "float32")),
               lambda: r.emit({}, "undeclared", zeros(())),
               lambda: r.emit({}, "a", zeros((2,)))):
        with pytest.raises(Exception) as e:
            fn()
        got.append(e.type)
    ctx = {}
    r.emit(ctx, "a", zeros(()))
    r.declare(m.MetricSpec("b", "s1", (), "float32"))
    with pytest.raises(Exception, match="b") as e:
        r.collect(ctx)
    got.append(e.type)
    assert set(r.collect(ctx, specs=(r.spec("a"),))) == {"a"}
    assert len(r) == 2 and "b" in r and "c" not in r
    return got


def test_registry_error_paths_raise_the_references_classes():
    ours = registry_errors(tm, torch.zeros)
    theirs = registry_errors(jtm, jnp.zeros)
    assert ours == theirs == [ValueError, KeyError, ValueError,
                              RuntimeError]


def test_emit_casts_to_the_declared_dtype():
    """A bool reduction (int64 in torch) lands as int32, a bool mask stays
    bool, a host number becomes a host tensor, and a tensor keeps its
    device."""
    specs = tm.cross_device_specs(4)
    r = tm.Telemetry(specs)
    ctx = {}
    fire = torch.tensor([True, False, True, True])
    r.emit(ctx, "occupancy", fire.sum())
    r.emit(ctx, "fire", fire)
    r.emit(ctx, "round", 7)
    r.emit(ctx, "cohort", torch.arange(4))
    r.emit(ctx, "wire_bytes", fire.sum().float() * 11.0)
    got = ctx["_tm"]
    assert got["occupancy"].dtype == torch.int32 and int(got["occupancy"]) == 3
    assert got["fire"].dtype == torch.bool
    assert got["round"].dtype == torch.int32 and got["round"].device.type \
        == "cpu" and int(got["round"]) == 7
    assert got["cohort"].dtype == torch.int32
    assert got["wire_bytes"].dtype == torch.float32
    assert {s.dtype for s in specs} == set(TORCH_DTYPES)


@pytest.mark.parametrize("kind", ["defta", "cross_device"])
def test_zero_frame_and_buffers_equal_the_references(kind):
    """The dead-tick zero frame (the port's driver runs no dead tick, but
    the registry keeps it) and the chunk buffers: the reference's names,
    order, shapes, dtypes and zeros."""
    def specs(m):
        return m.defta_specs(6, scenario=True, use_ef=True) \
            + m.tick_specs(6) if kind == "defta" \
            else m.cross_device_specs(4, use_ef=True)
    ours, theirs = tm.Telemetry(specs(tm)), jtm.Telemetry(specs(jtm))
    for got, want in ((ours.zero_frame(), theirs.zero_frame()),
                      (ours.zero_buffers(5), theirs.zero_buffers(5))):
        assert list(got) == list(want)
        for name in want:
            g, w = got[name].numpy(), np.asarray(want[name])
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert not g.any(), name
    assert ours.zero_frame(device="cpu")["round"].device.type == "cpu"


def test_gather_frames_is_one_host_copy_per_probe():
    bufs = {"round": torch.arange(3, dtype=torch.int32),
            "fire": torch.tensor([[True, False]] * 3),
            "host": np.ones(3)}
    got = gather_frames(bufs)
    assert list(got) == list(bufs)
    np.testing.assert_array_equal(got["round"], [0, 1, 2])
    assert got["fire"].dtype == np.bool_ and got["host"].dtype == np.float64


def test_identical_frames_give_identical_jsonl(tmp_path):
    """One set of numpy frames (every probe dtype, a scalar and a vector
    of each) through the port's ledger and sink and through the
    reference's: the files are equal byte for byte."""
    rng = np.random.default_rng(0)
    names = [s.name for s in jtm.cross_device_specs(4, use_ef=True)]
    chunks = []
    for n in (3, 2):
        chunk = {}
        for s in jtm.cross_device_specs(4, use_ef=True):
            shape = (n,) + s.shape
            if s.dtype == "bool":
                chunk[s.name] = rng.random(shape) < 0.5
            elif s.dtype == "int32":
                chunk[s.name] = rng.integers(0, 99, shape, dtype=np.int32)
            else:
                chunk[s.name] = rng.standard_normal(shape).astype(np.float32)
        chunks.append(chunk)
    meta = {"git": "abc", "time": 1.5, "seed": 3, "config": {"mode": "t"}}
    paths = []
    for m, mod in (("port", tm), ("ref", jtm)):
        path = tmp_path / f"{m}.jsonl"
        with mod.JsonlSink(str(path)) as sink:
            led = mod.RunLedger(sink=sink, meta=meta)
            start = 0
            for chunk in chunks:
                n = len(chunk["round"])
                led.record_dispatch(n, 0.25)
                led.record_frames(chunk, start)
                start += n
            led.finish("epochs", start)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    rows = [json.loads(ln) for ln in paths[0].read_text().splitlines()]
    assert [r["type"] for r in rows] == ["manifest"] + ["round"] * 5 + \
        ["summary"]
    assert list(rows[1]) == ["type", "t"] + names


def test_run_manifest_and_git_digest_follow_the_reference():
    m = tm.run_manifest(config={"a": np.float32(1.5), "b": (1, 2)}, seed=4,
                        argv=["x"], extra={"note": "y"})
    j = jtm.run_manifest(config={"a": np.float32(1.5), "b": (1, 2)}, seed=4,
                         argv=["x"], extra={"note": "y"})
    assert m.keys() == j.keys()
    assert {k: m[k] for k in m if k != "time"} == \
        {k: j[k] for k in j if k != "time"}
    assert tm.git_digest() == jtm.git_digest()
