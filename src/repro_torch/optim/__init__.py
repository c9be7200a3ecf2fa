from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    SGDState,
    sgd,
)
from repro_torch.optim import schedule  # noqa: F401
