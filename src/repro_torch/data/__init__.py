"""numpy copies of the reference's synthetic federated data."""
from repro_torch.data.synthetic import federated_dataset

__all__ = ["federated_dataset"]
