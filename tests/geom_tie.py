"""The geometry channel's half-mass tie (ROADMAP.md queue 3, item 3): the
reference's norm median under ``geom_scores`` (``weighted_median`` with
the receiver's self anchor at exactly half the mass) settles the tie by
its float32 cumsum and sum, the port's (``dts.anchored_median``) exactly.
The parity tests of worlds that meet such a tie swap the reference's norm
median in process for the exact one and show that its own pick leaves the
exact one only where its float32 arithmetic puts the crossing elsewhere.
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

import repro.core.dts as jdts


def exact_norm_median(vals, wts):
    """The exact lower weighted median of ``geom_scores``' norm median:
    the self anchor (the diagonal) carries the whole peer mass, so it is
    ``min(own, max over positive-weight peers)``, 0 for a row with no
    peer (the port's ``dts.anchored_median``)."""
    eye = jnp.eye(vals.shape[0], dtype=bool)
    peer_max = jnp.max(jnp.where(eye | (wts <= 0), -jnp.inf,
                                 vals[None, :, 0]), axis=1)
    med = jnp.minimum(vals[:, 0], peer_max)
    return jnp.where(jnp.isfinite(med), med, 0.0)[:, None]


def record_reference_norm_median(monkeypatch):
    """Swap the reference's norm median (``weighted_median`` under
    ``geom_scores``, its only caller) in process for the exact one, which
    the port computes, and record, each call, the reference's own inputs,
    its float32 cumsum and total and its own pick. Returns the record."""
    seen = []
    own_pick = jdts.weighted_median

    def recording_median(vals, wts):
        order = jnp.argsort(vals, axis=0)
        cw = jnp.cumsum(jnp.take(wts, order, axis=1), axis=1)
        jax.debug.callback(
            lambda *a: seen.append([np.asarray(x) for x in a]),
            vals[:, 0], wts, cw[..., 0], wts.sum(axis=1),
            own_pick(vals, wts)[:, 0])
        return exact_norm_median(vals, wts)

    monkeypatch.setattr(jdts, "weighted_median", recording_median)
    return seen


def reference_off_exact(seen) -> dict:
    """{call: [receivers]} where the reference's float32 pick leaves the
    exact lower weighted median. At each such row the exact crossing (in
    rationals, the self weight exactly the peer mass) and the reference's
    float32 crossing (its own cumsum against its own half total) are
    shown to fall at different sorted positions, each at its pick."""
    off = {}
    for call, (dn, wts, cw, total, pick) in enumerate(seen, start=1):
        exact = np.asarray(exact_norm_median(jnp.asarray(dn[:, None]),
                                             jnp.asarray(wts)))[:, 0]
        rows = np.nonzero(pick != exact)[0]
        order = np.argsort(dn, kind="stable")
        for r in rows:
            w = [Fraction(float(x)) for x in wts[r]]
            w[r] = sum(w[:r] + w[r + 1:], Fraction(0))
            half, cum, exact_pos = sum(w, Fraction(0)) / 2, Fraction(0), None
            for pos, j in enumerate(order):
                cum += w[j]
                if cum >= half:
                    exact_pos = pos
                    break
            jax_pos = int(np.argmax(cw[r] >= total[r] * np.float32(0.5)))
            assert dn[order[exact_pos]] == exact[r], (call, r)
            assert dn[order[jax_pos]] == pick[r], (call, r)
            assert jax_pos != exact_pos, (call, r)
        if rows.size:
            off[call] = rows.tolist()
    return off
