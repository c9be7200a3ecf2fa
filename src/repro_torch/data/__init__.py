from repro_torch.data import regression  # noqa: F401
from repro_torch.data.regression import (  # noqa: F401
    RegressionDataset, generate, squared_loss)
