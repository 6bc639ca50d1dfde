"""Production meshes on the H100 (the port of ``repro.launch.mesh``).

A pod is one HGX H100 node, eight cards joined all to all by NVLink:

    single pod: ("data", "model")        = (8, 1)     8 cards
    multi-pod:  ("pod", "data", "model") = (2, 8, 1)  16 cards, 2 nodes

The ``pod`` axis is DeFTA's worker axis, as in the reference: each pod is
one federated worker holding its own model replica, and cross-pod traffic
happens only in the gossip step. The model axis stays 1 because tensor
parallelism inside a pod is not ported (ROADMAP.md queue 1a item 12b);
the batch splits over the pods and the data axis, and the experts of a
MoE go over the data axis through expert parallelism
(``models.moe_eplocal``).

The meshes are ``sharding.Mesh`` grids of a device list. ``["meta"] * n``
(the default) makes the dry run's mesh, which allocates nothing; a list of
cards, or one card repeated, makes a real one.
"""
from __future__ import annotations

import dataclasses

from repro_torch import sharding
from repro_torch.config import MeshConfig

H100_POD = MeshConfig(multi_pod=False, data=8, model=1, pods=2)


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """The H100 production mesh (``H100_POD``, with the pod axis when
    ``multi_pod``) over ``devices``, default ``["meta"]`` for every card of
    the mesh."""
    cfg = dataclasses.replace(H100_POD, multi_pod=multi_pod)
    if devices is None:
        devices = ["meta"] * cfg.num_devices
    return sharding.make_mesh(cfg.shape, cfg.axis_names, devices)


def pod_mesh(mesh, pod: int = 0):
    """Pod ``pod``'s ("data", "model") mesh of a multi-pod mesh (the mesh
    itself when it has no pod axis): expert parallelism runs inside a
    pod."""
    if mesh.axis_names[0] != "pod":
        return mesh
    return sharding.Mesh(mesh.devices[pod], mesh.axis_names[1:])
