"""Run accounting (numpy only)."""
from repro_torch.telemetry.ledger import RunLedger

__all__ = ["RunLedger"]
