"""The telemetry plane (port of ``repro.telemetry``).

Device side (``spec``): a ``MetricSpec`` registry the round builders
declare probes into; stages emit frames that the drivers write into
preallocated device buffers, gathered to the host once a chunk.
``telemetry=None`` runs nothing.

Host side (``ledger``/``sinks``, numpy only): ``RunLedger`` keeps the
drivers' chunk and wall-clock accounting and the gathered probe frames,
and streams them into a JSONL sink after a run manifest header.
"""
from repro_torch.telemetry.spec import (
    MetricSpec,
    Telemetry,
    cross_device_specs,
    defta_specs,
    fedavg_specs,
    frame_bytes,
    stacked_payload_bytes,
    tick_specs,
    tree_payload_bytes,
    wire_payload_bytes,
)
from repro_torch.telemetry.ledger import RunLedger
from repro_torch.telemetry.sinks import JsonlSink, git_digest, run_manifest

__all__ = [
    "MetricSpec",
    "Telemetry",
    "RunLedger",
    "JsonlSink",
    "git_digest",
    "run_manifest",
    "frame_bytes",
    "wire_payload_bytes",
    "stacked_payload_bytes",
    "tree_payload_bytes",
    "defta_specs",
    "tick_specs",
    "fedavg_specs",
    "cross_device_specs",
]
