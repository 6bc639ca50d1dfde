"""The port's privacy wire, module by module, against its own contracts and
against live JAX.

``repro_torch.core.secagg`` draws its pads from Threefry-2x32 in plain
torch, so its pads are not the reference's ``jax.random.bits``; what both
packages hold is that the masked wire decodes bit for bit: the ring round
trip on every word (NaN, ±inf, -0 and subnormals included), directed
pads fresh per round, sender, receiver and tag, the group-sum cancellation
and dropout recovery, the masked mix equal to the unmasked K-slot
gather-sum (bit for bit on fp32; on int8 the same error as the unmasked
quantization, EF21 residuals included). The port's masked mix,
``dts.masked_geom_trust``, DP-SGD in ``local_train_fn`` and
``apply_update_dp`` (on the reference's own noise, replayed) are held
against the JAX functions on shared inputs; the byte and budget contracts
(``secagg_mask_bytes``, ``roofline.secagg_pad_bytes``, ``dp_epsilon``)
equal the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import dts as jdts
from repro.core import engine as jengine
from repro.core import gossip as jgossip
from repro.core import secagg as jsa
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from repro.launch import roofline as jroofline
from test_torch_scenario_slice import replay_dp_sgd

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import dts, engine, gossip
from repro_torch.core import secagg as sa
from repro_torch.core.tasks import mlp_task
from repro_torch.launch import roofline

WIRES = (None, "bf16", "int8")
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38, -1e-45,
                    np.finfo(np.float32).tiny / 3], np.float32)


def payload(rng, wire, shape=(64,)):
    x = rng.normal(size=shape).astype(np.float32)
    if wire == "bf16":
        return torch.tensor(x).to(torch.bfloat16)
    if wire == "int8":
        return torch.tensor(np.clip(np.round(x * 40), -127, 127)
                            .astype(np.int8))
    return torch.tensor(x)


def ekey(seed):
    return sa.domain_key(sa.secagg_base_key(seed), sa.DOMAIN_EDGE)


# ---------------------------------------------------------------------------
# The generator and the ring
# ---------------------------------------------------------------------------

def test_threefry_known_answers_and_jax():
    """Random123's known-answer vectors for Threefry-2x32-20, and JAX's own
    ``threefry_2x32`` on random words, through Python ints and through
    ``int64`` tensors alike."""
    from jax._src.prng import threefry_2x32
    m = 0xFFFFFFFF
    for key, ctr, want in (((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
                           ((m, m), (m, m), (0x1cb996fc, 0xbb002be7)),
                           ((0x13198a2e, 0x03707344),
                            (0x243f6a88, 0x85a308d3),
                            (0xc4923a9c, 0x483df7a0))):
        assert sa.threefry2x32(*key, *ctr) == want
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64)
    c0, c1 = rng.integers(0, 2**32, (2, 257), dtype=np.uint64)
    want = np.asarray(threefry_2x32(jnp.asarray(key, jnp.uint32),
                                    jnp.asarray(np.concatenate([c0, c1]),
                                                jnp.uint32)))
    x0, x1 = sa.threefry2x32(int(key[0]), int(key[1]),
                             torch.tensor(c0.astype(np.int64)),
                             torch.tensor(c1.astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([x0.numpy(), x1.numpy()]),
                                  want.astype(np.int64))


def test_base_key_is_the_references_integer():
    for seed in (0, 7, 123456):
        assert sa.secagg_base_key(seed) == \
            int(np.asarray(jsa.secagg_base_key(seed))[1])


@pytest.mark.parametrize("wire", (None, "fp32", "bf16", "int8"))
def test_ring_roundtrip_bitwise_every_word(wire):
    rng = np.random.default_rng(0)
    p = payload(rng, None if wire == "fp32" else wire, (96,))
    if wire in (None, "fp32"):
        p = torch.cat([p, torch.tensor(SPECIAL)])
    elif wire == "bf16":
        p = torch.cat([p, torch.tensor(SPECIAL).to(torch.bfloat16)])
    else:
        p = torch.cat([p, torch.tensor([-128, 127, 0, -1], dtype=torch.int8)])
    pads = sa.edge_pad(ekey(0), 3, 1, 2, p.shape, wire)
    wire_words = sa.mask_payload(p, pads, wire)
    rec = sa.unmask_payload(wire_words, pads, wire)
    assert rec.dtype == p.dtype
    np.testing.assert_array_equal(sa.ring_bits(rec, wire).numpy(),
                                  sa.ring_bits(p, wire).numpy())
    # the words span the ring and never leave it
    hi = 1 << sa.RING_BITS[wire]
    assert int(wire_words.long().min()) >= 0
    assert int(wire_words.long().max()) < hi


@pytest.mark.parametrize("wire", WIRES)
def test_pads_directed_pair_pads_symmetric(wire):
    """``pair_pad`` is keyed on the unordered pair; ``edge_pad`` is directed
    (i -> j and j -> i never share a pad in a round)."""
    base = ekey(7)
    for i, j in ((0, 1), (3, 9), (5, 2)):
        np.testing.assert_array_equal(
            sa.pair_pad(base, 4, i, j, (32,), wire).numpy(),
            sa.pair_pad(base, 4, j, i, (32,), wire).numpy())
        assert not np.array_equal(sa.edge_pad(base, 4, i, j, (32,),
                                              wire).numpy(),
                                  sa.edge_pad(base, 4, j, i, (32,),
                                              wire).numpy())


def test_pads_fresh_per_round_sender_receiver_tag():
    base = ekey(0)
    ref = sa.edge_pad(base, 1, 2, 3, (64,), None, tag=0).numpy()
    for r, s, d, t in ((2, 2, 3, 0), (1, 4, 3, 0), (1, 2, 5, 0),
                       (1, 2, 3, 1)):
        other = sa.edge_pad(base, r, s, d, (64,), None, tag=t).numpy()
        assert not np.array_equal(ref, other), (r, s, d, t)
    assert not np.array_equal(ref, sa.edge_pad(ekey(1), 1, 2, 3, (64,),
                                               None).numpy())
    # within one pad, words are not repeated in pairs (both Threefry
    # outputs are used, for words 2p and 2p + 1)
    assert len(np.unique(ref)) == ref.size


def test_pad_block_equals_channel_by_channel_pads():
    """One block for all channels gives each channel the pads it would get
    alone; a 0-dim round tensor keys them as the int does."""
    base = ekey(3)
    idx = torch.tensor([[0, 2, 1], [1, 0, 1], [2, 1, 2]])
    recv = torch.arange(3)[:, None]
    channels = ((0, 7), (1, 1), (2, 10), (3, 1))
    block = sa.pad_block(base, 5, idx, recv, channels)
    block_t = sa.pad_block(base, torch.tensor(5), idx, recv, channels)
    for (tag, width), got, got_t in zip(channels, block, block_t):
        want = sa.pad_block(base, 5, idx, recv, ((tag, width),))[0]
        assert got.shape == (3, 3, width)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got_t.numpy(), want.numpy())
        one = sa.edge_pad(base, 5, 1, 2, (width,), None, tag=tag)
        np.testing.assert_array_equal(got[2, 1].numpy(), one.numpy())


def test_counter_fields_refuse_what_does_not_fit():
    with pytest.raises(ValueError, match="tag"):
        sa.pad_block(ekey(0), 0, torch.tensor(0), torch.tensor(1),
                     ((256, 4),))
    with pytest.raises(ValueError, match="16 bits"):
        sa.edge_pad(ekey(0), 0, 1 << 16, 1, (4,))


@pytest.mark.parametrize("wire", WIRES)
def test_wire_differs_from_plaintext(wire):
    """The pad is uniform on the ring: a wire word equals its plaintext
    word only where the pad word is 0 (2^-n per word)."""
    rng = np.random.default_rng(3)
    p = payload(rng, wire, (4096,))
    bits = sa.ring_bits(p, wire).numpy()
    words = sa.mask_payload(p, sa.edge_pad(ekey(3), 0, 0, 1, p.shape, wire),
                            wire).numpy()
    frac = float((words == bits).mean())
    assert frac < (4.0 / 256 if wire == "int8" else 0.01), frac
    assert not np.array_equal(words, bits)


# ---------------------------------------------------------------------------
# Group sum and dropout recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_group_sum_cancels_exactly(wire, seed):
    rng = np.random.default_rng(seed)
    group = sorted(rng.choice(9, size=rng.integers(2, 10),
                              replace=False).tolist())
    base = ekey(seed)
    xs = {i: payload(rng, wire, (128,)) for i in group}
    mod = 1 << sa.RING_BITS[wire]
    total = sum(sa.group_wire(xs[i], base, 5, i, group, wire).numpy()
                .astype(np.uint64) for i in group) % mod
    want = sum(sa.ring_bits(xs[i], wire).numpy().astype(np.uint64)
               for i in group) % mod
    np.testing.assert_array_equal(total, want)
    # one wire alone hides its payload
    i = group[0]
    assert not np.array_equal(sa.group_wire(xs[i], base, 5, i, group,
                                            wire).numpy(),
                              sa.ring_bits(xs[i], wire).numpy())


@pytest.mark.parametrize("wire", WIRES)
def test_dropout_reconstruct_and_subtract(wire):
    rng = np.random.default_rng(4)
    group, dropped = [0, 2, 3, 6, 7], 3
    survivors = [i for i in group if i != dropped]
    base = ekey(4)
    xs = {i: payload(rng, wire, (128,)) for i in group}
    mod = 1 << sa.RING_BITS[wire]
    got = sum(sa.group_wire(xs[i], base, 2, i, group, wire).numpy()
              .astype(np.uint64) for i in survivors)
    corr = sa.dropout_correction(base, 2, dropped, survivors, (128,),
                                 wire).numpy().astype(np.uint64)
    want = sum(sa.ring_bits(xs[i], wire).numpy().astype(np.uint64)
               for i in survivors) % mod
    np.testing.assert_array_equal((got + mod - corr) % mod, want)
    assert not np.array_equal(got % mod, want)


def test_legacy_float_masks():
    """The float-domain primitives keep what ``test_extensions.py`` checks
    of the reference's: the wire is not the model, the receiver recovers
    it, the mask is symmetric in the pair and fresh per round."""
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    wire, rec = sa.secure_roundtrip(params, 2, 5, round_=7)
    assert float((wire["w"] - params["w"]).abs().max()) > 0.1
    for k in params:
        np.testing.assert_allclose(rec[k].numpy(), params[k].numpy(),
                                   atol=1e-6)
    tree = {"a": torch.zeros(4, 3), "b": torch.zeros(5)}
    ma, mb = sa.mask_for(tree, 2, 5, 1), sa.mask_for(tree, 5, 2, 1)
    for k in tree:
        np.testing.assert_array_equal(ma[k].numpy(), mb[k].numpy())
    assert not torch.equal(sa.mask_for(tree, 2, 5, 2)["a"], ma["a"])
    assert sa.pair_seed(3, 1, 4) == jsa.pair_seed(3, 1, 4)


# ---------------------------------------------------------------------------
# The masked mix
# ---------------------------------------------------------------------------

def random_world(seed, w=8, f=96):
    rng = np.random.default_rng(seed)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        adj[i, rng.choice([j for j in range(w) if j != i], size=3,
                          replace=False)] = True
    P = (adj | np.eye(w, dtype=bool)).astype(np.float32)
    P *= rng.uniform(0.5, 1.5, P.shape).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    stacked = {"a": rng.normal(size=(w, f)).astype(np.float32),
               "b": rng.normal(size=(w, f // 4, 2)).astype(np.float32)}
    return P, adj, stacked


def gather_sum(P, adj, stacked, wire=None, residual=None):
    """The unmasked K-slot gather-sum of the encoded rows, in the port's
    arithmetic: what the masked mix must reproduce."""
    idx, val = gossip.sparse_weights(P, adj)
    idx = idx.long()
    out, res = {}, {}
    for name, x in stacked.items():
        flat = x.reshape(x.shape[0], -1)
        r = residual[name].reshape(flat.shape) if residual else None
        if wire is None:
            pay, scale, nr = flat, None, None
        else:
            pay, scale, nr = gossip._encode_rows(flat, r, wire)
        wts = val * scale[idx] if scale is not None else val
        out[name] = torch.einsum("wk,wkf->wf", wts,
                                 pay[idx].float()).reshape(x.shape)
        res[name] = nr.reshape(x.shape) if nr is not None else None
    return out, res


@pytest.mark.parametrize("seed", (0, 5))
@pytest.mark.parametrize("round_", (0, 3))
def test_fp32_masked_mix_bitwise_vs_unmasked_gather_sum(seed, round_):
    P, adj, st = random_world(seed)
    P_t = torch.tensor(P)
    st_t = {k: torch.tensor(v) for k, v in st.items()}
    out = gossip.mix_pytree(P_t, st_t, "auto", adjacency=adj,
                            secagg=sa.secagg_base_key(seed),
                            secagg_round=round_)
    want, _ = gather_sum(P_t, adj, st_t)
    for k in st:
        assert torch.equal(out[k], want[k]), k


@pytest.mark.parametrize("wire", ("bf16", "int8"))
def test_lossy_masked_mix_and_ef21_equal_unmasked(wire):
    """On the lossy wires the masked mix decodes the identical words: the
    output and the EF21 residual equal the unmasked encode's, bit for bit."""
    P, adj, st = random_world(2)
    P_t = torch.tensor(P)
    st_t = {k: torch.tensor(v) for k, v in st.items()}
    rng = np.random.default_rng(9)
    residual = {k: torch.tensor(0.01 * rng.normal(size=v.shape)
                                .astype(np.float32)) for k, v in st.items()}
    on, r_on = gossip.mix_pytree(P_t, st_t, "auto", adjacency=adj,
                                 wire=wire, residual=residual,
                                 secagg=sa.secagg_base_key(2),
                                 secagg_round=1)
    want, r_want = gather_sum(P_t, adj, st_t, wire, residual)
    for k in st:
        assert torch.equal(on[k], want[k]), k
        assert torch.equal(r_on[k], r_want[k]), k


def test_int8_masked_roundtrip_error_equals_unmasked_quant_error():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(6, 256)).astype(np.float32))
    q, scale = gossip.quantize_rows_int8(x)
    base = ekey(1)
    pq = sa.edge_pad(base, 0, 1, 2, q.shape, "int8")
    ps = sa.edge_pad(base, 0, 1, 2, scale.shape, None, tag=1)
    q_rec = sa.unmask_payload(sa.mask_payload(q, pq, "int8"), pq, "int8")
    s_rec = sa.unmask_payload(sa.mask_payload(scale, ps), ps)
    assert torch.equal(q_rec, q)
    assert torch.equal(sa.ring_bits(s_rec), sa.ring_bits(scale))
    np.testing.assert_array_equal(
        (q_rec.float() * s_rec[:, None] - x).abs().numpy(),
        (q.float() * scale[:, None] - x).abs().numpy())


def test_masked_mix_never_launches_a_kernel(monkeypatch):
    """Under secagg every backend runs the gather-sum: no mix kernel."""
    from repro_torch.kernels import ops
    P, adj, st = random_world(0)

    def boom(*a, **k):
        raise AssertionError("a mix kernel ran on a secagg round")
    for name in ("gossip_mix", "gossip_mix_sparse", "gossip_mix_quant"):
        monkeypatch.setattr(ops, name, boom)
    for backend, wire in (("auto", None), ("pallas", "bf16"),
                          ("sparse", "int8")):
        gossip.mix_pytree(torch.tensor(P),
                          {k: torch.tensor(v) for k, v in st.items()},
                          backend, adjacency=adj, wire=wire, secagg=11)


def test_secagg_needs_adjacency():
    P, _, st = random_world(0)
    with pytest.raises(ValueError, match="adjacency"):
        gossip.mix_pytree(torch.tensor(P),
                          {k: torch.tensor(v) for k, v in st.items()},
                          secagg=sa.secagg_base_key(0), secagg_round=0)


@pytest.mark.parametrize("wire,ef,stochastic", [
    (None, False, False), ("bf16", False, False), ("bf16", True, False),
    ("int8", False, False), ("int8", True, True)])
def test_masked_mix_matches_jax(wire, ef, stochastic):
    """The port's masked mix against the reference's on shared inputs (the
    int8 stochastic wire on the reference's uniforms): within 1e-6, the
    int8 wire within one quantization step of each row."""
    P, adj, st = random_world(4, w=9, f=40)
    rng = np.random.default_rng(5)
    residual = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
                for k, v in st.items()} if ef else None
    rnd = "stochastic" if stochastic else "nearest"
    wkey = jax.random.PRNGKey(3) if stochastic else None
    jout = jgossip.mix_pytree(
        jnp.asarray(P), {k: jnp.asarray(v) for k, v in st.items()},
        adjacency=adj, wire=wire,
        residual=None if residual is None else
        {k: jnp.asarray(v) for k, v in residual.items()},
        wire_round=rnd, wire_key=wkey,
        secagg=jsa.secagg_base_key(4), secagg_round=2)
    wire_u = None
    if stochastic:
        names = sorted(st)
        keys = jax.random.split(wkey, len(names))
        wire_u = {nm: torch.tensor(np.asarray(jax.random.uniform(
            k, (st[nm].shape[0], st[nm][0].size), jnp.float32)))
            for nm, k in zip(names, keys)}
    out = gossip.mix_pytree(
        torch.tensor(P), {k: torch.tensor(v) for k, v in st.items()},
        "auto", adjacency=adj, wire=wire,
        residual=None if residual is None else
        {k: torch.tensor(v) for k, v in residual.items()},
        wire_round=rnd, wire_u=wire_u, secagg=sa.secagg_base_key(4),
        secagg_round=2)
    if ef:
        (jout, jres), (out, res) = jout, out
    for k, v in st.items():
        got, want = out[k].float().numpy(), np.asarray(jout[k], np.float32)
        if wire == "int8":
            step = np.abs(v.reshape(v.shape[0], -1)).max() / 127.0
            assert np.abs(got - want).max() <= step, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        if ef:
            tol = step if wire == "int8" else 1e-6
            assert np.abs(res[k].numpy() - np.asarray(jres[k])).max() \
                <= tol, k


# ---------------------------------------------------------------------------
# Trust and DP functions against live JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("masked", (False, True))
def test_masked_geom_trust_matches_jax(seed, masked):
    rng = np.random.default_rng(seed)
    w, d = 9, 50
    P = rng.uniform(0, 1, (w, w)).astype(np.float32)
    P *= rng.random((w, w)) < 0.5
    P[2] = 0.0
    P[2, 2] = 1.0                       # a row with no off-diagonal mass
    np.fill_diagonal(P, np.maximum(np.diag(P), 0.1))
    P /= P.sum(1, keepdims=True)
    deltas = rng.normal(size=(w, d)).astype(np.float32)
    deltas[5] = 0.0                     # a worker that did not move
    mask = rng.random((w, w)) < 0.7 if masked else None
    if masked:
        mask[4] = False                 # every peer gated off
    want = np.asarray(jdts.masked_geom_trust(
        jnp.asarray(deltas), jnp.asarray(P),
        None if mask is None else jnp.asarray(mask)))
    got = dts.masked_geom_trust(torch.tensor(deltas), torch.tensor(P),
                                None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got[2] == 0.0 and (not masked or got[4] == 0.0)


def dp_world():
    data = jfederated_dataset("vector", 4, np.random.default_rng(2),
                              n_per_worker=40, alpha=0.5)
    params = jax.vmap(jmlp_task(32, 10).init)(
        jax.random.split(jax.random.PRNGKey(1), 4))
    return data, params


@pytest.mark.parametrize("clip,sigma", [(1.0, 0.5), (50.0, 0.0),
                                        (0.05, 2.0)])
def test_dp_sgd_local_train_matches_jax(clip, sigma):
    """DP-SGD on the reference's own noise and permutations: clip 1 (norms
    above it), 50 (every norm below it: the scale stays 1) and 0.05."""
    data, jparams = dp_world()
    train_kw = dict(learning_rate=0.05, batch_size=16)
    epochs, w = 2, 4
    ltrain = jengine.local_train_fn(jmlp_task(32, 10),
                                    JTrainConfig(**train_kw), epochs,
                                    dp_clip=clip, dp_sigma=sigma)
    k_train = jax.random.PRNGKey(9)
    x, y, m = (jnp.asarray(data[k]) for k in ("x", "y", "mask"))
    want, wloss = jax.vmap(ltrain)(jax.random.split(k_train, w), jparams,
                                   x, y, m)
    n = data["x"].shape[1]
    steps = max(n // train_kw["batch_size"], 1)
    params = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    noise = replay_dp_sgd(k_train, {k: (w, epochs, steps) + v.shape[1:]
                                    for k, v in params.items()})
    run = engine.local_train_fn(mlp_task(32, 10), TrainConfig(**train_kw),
                                epochs, dp_clip=clip, dp_sigma=sigma)
    got, loss = run(slice_helpers.replay_perm(k_train, w, epochs, n),
                    params, torch.tensor(data["x"]),
                    torch.tensor(data["y"]).long(), torch.tensor(data["mask"]),
                    noise)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(loss.numpy(), np.asarray(wloss), rtol=1e-5,
                               atol=1e-5)


def test_dp_sgd_keeps_the_epsilon_inside_the_root():
    """A linear loss whose gradient norm is 1e-6, on the order of the
    1e-12 the clip factor adds under the square root: the port's factor
    ``min(1, clip / sqrt(Σ⟨g, g⟩ + 1e-12))`` is the reference's (with the
    1e-12 outside the root the factor would be 0.5, not 0.354)."""
    from repro.core.tasks import Task as JTask

    from repro_torch.core.tasks import Task
    w, n = 3, 16
    x = np.full((w, n, 1), 1e-6, np.float32)
    y = np.zeros((w, n), np.int32)
    m = np.ones((w, n), np.float32)
    p0 = np.zeros((w, 1), np.float32)
    jtask = JTask("lin", None, lambda p, xx, yy, mm: (xx * p["w"]).sum(-1)
                  .mean(), None)
    jrun = jengine.local_train_fn(jtask, JTrainConfig(learning_rate=1.0,
                                                      batch_size=n), 1,
                                  dp_clip=5e-7, dp_sigma=0.0)
    k_train = jax.random.PRNGKey(2)
    want, _ = jax.vmap(jrun)(jax.random.split(k_train, w),
                             {"w": jnp.asarray(p0)}, jnp.asarray(x),
                             jnp.asarray(y), jnp.asarray(m))
    task = Task("lin", None, lambda p, xx, yy, mm: (xx * p["w"][:, None])
                .sum(-1).mean(-1), None)
    run = engine.local_train_fn(task, TrainConfig(learning_rate=1.0,
                                                  batch_size=n), 1,
                                dp_clip=5e-7, dp_sigma=0.0)
    got, _ = run(slice_helpers.replay_perm(k_train, w, 1, n),
                 {"w": torch.tensor(p0)}, torch.tensor(x),
                 torch.tensor(y), torch.tensor(m),
                 replay_dp_sgd(k_train, {"w": (w, 1, 1, 1)}))
    step = -got["w"].numpy()
    np.testing.assert_allclose(step, -np.asarray(want["w"]), rtol=1e-5)
    np.testing.assert_allclose(step, 1e-6 * 5e-7 / np.sqrt(2e-12),
                               rtol=1e-3)


@pytest.mark.parametrize("clip,zero", [(1.0, False), (1e3, False),
                                       (1.0, True)])
def test_apply_update_dp_matches_jax(clip, zero):
    """Update DP on the reference's own ``split(k_dp, n_leaves)`` noise: a
    norm above the clip, every norm below it, and a zero delta."""
    _, start = dp_world()
    rng = np.random.default_rng(3)
    trained = {k: v if zero else v + 0.3 * rng.normal(size=v.shape)
               .astype(np.float32) for k, v in start.items()}
    jcfg = JDeFTAConfig(dp_sigma=0.7, dp_update_clip=clip)
    k_dp = jax.random.PRNGKey(4)
    want = jengine.apply_update_dp(jcfg, k_dp, start,
                                   {k: jnp.asarray(v)
                                    for k, v in trained.items()})
    noise = slice_helpers.replay_noise(
        k_dp, {k: tuple(v.shape) for k, v in start.items()})
    got = engine.apply_update_dp(
        DeFTAConfig(dp_sigma=0.7, dp_update_clip=clip), noise,
        {k: torch.tensor(np.asarray(v)) for k, v in start.items()},
        {k: torch.tensor(np.asarray(v)) for k, v in trained.items()})
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("clip,sigma", [(0.0, 0.0), (0.0, 1.0), (1.0, 0.5),
                                        (1.0, 0.0)])
def test_uses_update_dp_equals_reference(clip, sigma):
    assert engine.uses_update_dp(DeFTAConfig(dp_clip=clip, dp_sigma=sigma)) \
        == jengine.uses_update_dp(JDeFTAConfig(dp_clip=clip, dp_sigma=sigma))


# ---------------------------------------------------------------------------
# Byte and budget contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", (None, "fp32", "bf16", "int8"))
def test_mask_bytes_equal_the_roofline(wire):
    adj = np.random.default_rng(0).random((11, 11)) < 0.3
    a = adj.copy()
    np.fill_diagonal(a, False)
    n_params, rows = 2762, 4
    realized = sa.secagg_mask_bytes(int(a.sum()), n_params, wire, rows=rows)
    roof = roofline.secagg_pad_bytes(adj, n_params, wire, rows=rows)
    assert float(realized) == roof["pad_bytes"]
    assert roof == jroofline.secagg_pad_bytes(adj, n_params, wire, rows=rows)
    assert realized == jsa.secagg_mask_bytes(int(a.sum()), n_params, wire,
                                             rows=rows)
    assert roof["wire_overhead_bytes"] == 0.0


@pytest.mark.parametrize("sigma,rounds,delta", [(0.5, 24, 1e-5),
                                                (1.0, 24, 1e-5),
                                                (2.0, 100, 1e-6),
                                                (0.0, 5, 1e-5)])
def test_dp_epsilon_equals_reference(sigma, rounds, delta):
    assert roofline.dp_epsilon(sigma, rounds, delta=delta) == \
        jroofline.dp_epsilon(sigma, rounds, delta=delta)
