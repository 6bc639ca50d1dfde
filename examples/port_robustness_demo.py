"""Robustness demo on the PyTorch port: the alie-vs-DTS-v3 showdown (the
port's version of ``examples/robustness_demo.py``).

k = 4 ALIE colluders ("a little is enough") join 12 vanilla workers on a
non-iid partition. Every colluder ships the identical ``mean − z·std`` of
the worker stack, a coordinated shift hiding inside the honest variance:
stealthy to the paper's loss-delta trust and to single-round update
geometry. What the colluders cannot hide is each other: across rounds
their updates correlate at ≈ 1 while non-iid honest updates decorrelate,
and that is what ``dts_signal="all"`` (loss + geometry + the DTS v3
cross-round sketch correlation) scores.

The demo runs the same scenario with the paper's DTS (``"loss"``) and
with ``"all"``, and prints the ASCII picture of the sampling weights θ at
epochs 8 and 24, the honest workers' θ mass on the colluders, the gossip
kernel launches of each run and the fill of the sketch ring buffer. A
straggler runs throughout: its ring buffer rotates only on the rounds it
ran.

    PYTHONPATH=src python examples/port_robustness_demo.py [--device cpu]

Runs on the card unless ``--device cpu`` is given. Imports nothing of JAX
or of the ``repro`` package.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core import dts  # noqa: E402
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.scenarios import (AttackSpec, ScenarioSpec,  # noqa: E402
                                   StragglerSpec, compile_scenario)

VANILLA, COLLUDERS, EPOCHS = 12, 4, 24

SCENARIO = ScenarioSpec(
    name="alie_showdown",
    attacks=tuple(AttackSpec("alie") for _ in range(COLLUDERS)),
    stragglers=(StragglerSpec(worker=5, speed=0.5),),
)


def trust_picture(theta, adj, malicious, alive):
    chars = " .:-=+*#%@"
    lines = []
    for i in range(len(theta)):
        row = []
        for j in range(len(theta)):
            if not adj[i, j]:
                row.append(" ")
            else:
                row.append(chars[min(int(theta[i, j] * 3 * 9), 9)])
        mark = "M" if malicious[i] else ("x" if not alive[i] else " ")
        lines.append(f"  {i:2d}{mark} |" + "".join(row) + "|")
    head = "       " + "".join(
        "M" if malicious[j] else str(j % 10) for j in range(len(theta)))
    return head + "\n" + "\n".join(lines) + "\n  (M=malicious, x=left)"


def attacker_share(theta, malicious):
    return float(theta[~malicious][:, malicious].sum(axis=1).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    data = federated_dataset("vector", VANILLA, rng, n_per_worker=120,
                             alpha=0.5)                        # non-iid
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)

    compiled = compile_scenario(SCENARIO, VANILLA, EPOCHS, device=dev)
    print(f"scenario: {SCENARIO.name}, W={compiled.num_workers} "
          f"({VANILLA} vanilla + {int(compiled.malicious.sum())} alie "
          f"colluders), straggler worker 5 at half speed, {EPOCHS} epochs")

    final = {}
    for signal in ("loss", "all"):
        cfg = DeFTAConfig(num_workers=VANILLA, avg_peers=4, num_sampled=2,
                          local_epochs=3, dts_signal=signal)
        print(f"\n{'=' * 66}\ndts_signal={signal}"
              + ("  (paper DTS: scalar loss delta)" if signal == "loss"
                 else "  (DTS v3 fusion: loss + geometry + cross-round "
                      "correlation)"))
        # θ at two horizons, each a run from scratch: the runs are
        # deterministic (one seed), so the epoch-8 state inside the
        # 24-epoch run is the 8-epoch run's
        for upto in (8, EPOCHS):
            ops.reset_launches()
            st, adj, malicious, _ = run_defta(0, task, cfg, train, data,
                                              epochs=upto, scenario=compiled,
                                              device=dev)
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            theta = dts.sample_weights(
                st.conf, torch.as_tensor(adj).to(dev)).cpu().numpy()
            alive = compiled.alive_np[compiled.seg_of_epoch_np[upto - 1]]
            share = attacker_share(theta, malicious)
            print(f"\n  epoch {upto}: sampling weights θ (rows=receiver, "
                  f"cols=sender) — kernel launches {launches}, "
                  f"attacker-θ share {share:.3f}")
            print(trust_picture(theta, adj, malicious, alive))
        if st.sketch is not None:
            filled = (st.sketch.abs().amax(dim=2) > 0).sum(dim=1).cpu()
            print(f"  sketch ring buffer: {tuple(st.sketch.shape)}, "
                  f"{int(filled.max())}/{st.sketch.shape[1]} rounds of "
                  f"history filled (the straggler, worker 5: "
                  f"{int(filled[5])}, its epoch {int(st.epoch[5])})")
        m, s, _ = evaluate(task, st, data["test_x"], data["test_y"],
                           malicious)
        final[signal] = (m, share)
        print(f"  final honest accuracy: {m:.3f} ± {s:.3f}")

    (acc_l, th_l), (acc_a, th_a) = final["loss"], final["all"]
    print(f"\n{'=' * 66}\nshowdown: loss {acc_l:.3f} (attacker-θ {th_l:.3f})"
          f"  vs  all {acc_a:.3f} (attacker-θ {th_a:.3f})"
          f"  ->  {acc_a - acc_l:+.3f} honest accuracy from the "
          f"correlation channel")
    return final


if __name__ == "__main__":
    main()
