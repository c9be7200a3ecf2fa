from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    SGDState,
    adamw,
    sgd,
)
from repro_torch.optim import schedule  # noqa: F401
