"""numpy copies of the reference's synthetic federated data and its
partitions."""
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition, shard_partition,
)
from repro_torch.data.synthetic import (  # noqa: F401
    federated_dataset, make_classification, make_image_classification,
    make_lm_stream,
)
