"""Production meshes on the H100 (the port of ``repro.launch.mesh``).

A pod is one HGX H100 node, eight cards joined all to all by NVLink:

    single pod: ("data", "model")        = (2, 4)     8 cards
    multi-pod:  ("pod", "data", "model") = (2, 2, 4)  16 cards, 2 nodes

Both of the reference's axes are larger than 1 inside one NVLink node, as
its (16, 16) is: tensor parallelism runs over "model" (the parameters
placed by logical axis, ``sharding.place``), the batch and a MoE's experts
(expert parallelism, ``models.moe_eplocal``) over "data". The ``pod`` axis
is DeFTA's worker axis, as in the reference: each pod is one federated
worker holding its own model replica, and cross-pod traffic happens only in
the gossip step.

The meshes are ``sharding.Mesh`` grids of a device list. ``["meta"] * n``
(the default) makes the dry run's mesh, which allocates nothing; a list of
cards, or one card repeated, makes a real one. ``make_debug_mesh`` is the
launcher's ``--debug-mesh``: (2, 2), with the pod axis (pods, 2, 2), over
a device repeated.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import sharding
from repro_torch.config import MeshConfig

H100_POD = MeshConfig(multi_pod=False, data=2, model=4, pods=2)


def make_production_mesh(*, multi_pod: bool = False, devices=None,
                         pod=None):
    """The H100 production mesh (``H100_POD``, with the pod axis when
    ``multi_pod``) over ``devices``, default ``["meta"]`` for every card of
    the mesh; ``pod`` replaces a pod's (data, model) shape (the earlier
    (8, 1), say)."""
    cfg = dataclasses.replace(H100_POD, multi_pod=multi_pod)
    if pod is not None:
        cfg = dataclasses.replace(cfg, data=pod[0], model=pod[1])
    if devices is None:
        devices = ["meta"] * cfg.num_devices
    return make_mesh(cfg, devices)


def make_mesh(cfg: MeshConfig, devices=None):
    """The mesh of a ``MeshConfig`` over ``devices`` (default the first
    cards visible)."""
    return sharding.make_mesh(cfg.shape, cfg.axis_names, devices)


def make_debug_mesh(data: int = 2, model: int = 2, pods: int = 0,
                    devices=None):
    """A small mesh for CPU tests and ``--debug-mesh``: (data, model), or
    (pods, data, model), over ``devices`` (default ``["cpu"]`` repeated)."""
    shape = (pods, data, model) if pods else (data, model)
    axes = ("pod", "data", "model") if pods else ("data", "model")
    if devices is None:
        devices = ["cpu"] * math.prod(shape)
    return sharding.make_mesh(shape, axes, devices)


def pod_mesh(mesh, pod: int = 0):
    """Pod ``pod``'s ("data", "model") mesh of a multi-pod mesh (the mesh
    itself when it has no pod axis): expert parallelism runs inside a
    pod."""
    if mesh.axis_names[0] != "pod":
        return mesh
    return sharding.Mesh(mesh.devices[pod], mesh.axis_names[1:])
