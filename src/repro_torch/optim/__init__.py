from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adam, make_optimizer, sgd,
)
from repro_torch.optim.schedules import cosine_schedule, warmup_linear  # noqa: F401
