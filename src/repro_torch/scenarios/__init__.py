"""The adversarial scenario engine (port of ``repro.scenarios``):
declarative churn, attack and fault timelines compiled once to per-epoch
tensors.

* ``spec``       — the ``ScenarioSpec`` grammar, a verbatim copy of the
                   reference's (attacks, churn, links, partitions,
                   stragglers, time-varying topologies; the presets behind
                   ``get_scenario``).
* ``compile``    — ``compile_scenario(spec, num_vanilla, epochs, device)``
                   evaluates the timeline on the host into segment-
                   compressed alive/link masks and per-epoch fire/attack-on
                   schedules; ``epoch_view`` is the round's per-epoch
                   lookup.
* ``attacks``    — the attack zoo (what malicious workers send, or for
                   label_flip what they train on).
* ``robust_agg`` — the classical robust rules (trimmed_mean, median,
                   krum), selected by ``cfg.aggregation``.
* ``cross_device`` — cross-device participation worlds, a verbatim copy
                   of the reference's (``CrossDeviceSpec``: an enrolled
                   population, a cohort of k sampled each round, dropout
                   and stragglers on by default; ``compile_world`` lays
                   the whole participation timeline out on the host).

Quick start::

    from repro_torch.scenarios import AttackSpec, ChurnSpec, ScenarioSpec
    spec = ScenarioSpec(attacks=(AttackSpec("sign_flip"),),
                        churn=(ChurnSpec(worker=0, leave=6),))
    state, adj, mal, hist = run_defta(0, task, cfg, train, data,
                                      epochs=20, scenario=spec)
"""
from repro_torch.scenarios.compile import (ATTACK_CODE, CompiledScenario,
                                           compile_scenario, epoch_view)
from repro_torch.scenarios.cross_device import (CompiledWorld,
                                                CrossDeviceSpec,
                                                compile_world)
from repro_torch.scenarios.robust_agg import ROBUST_RULES, robust_mix
from repro_torch.scenarios.spec import (ATTACK_KINDS, AttackSpec, ChurnSpec,
                                        LinkSpec, PartitionSpec,
                                        ScenarioSpec, StragglerSpec,
                                        TopologySpec, get_scenario)

__all__ = [
    "ATTACK_CODE", "ATTACK_KINDS", "AttackSpec", "ChurnSpec",
    "CompiledScenario", "CompiledWorld", "CrossDeviceSpec", "LinkSpec",
    "PartitionSpec", "ROBUST_RULES", "ScenarioSpec", "StragglerSpec",
    "TopologySpec", "compile_scenario", "compile_world", "epoch_view",
    "get_scenario", "robust_mix",
]
