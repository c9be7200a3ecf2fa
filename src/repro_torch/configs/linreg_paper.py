"""The paper's own experiment: linear regression (paper §4, Corollary 1),
port of ``repro.configs.linreg_paper``.

Not one of the assigned architectures: the paper-faithful validation
target with known L = M = 1 (=> eta = 1/2)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinRegConfig:
    name: str = "linreg-paper"
    dim: int = 100               # d
    total_samples: int = 50_000  # N
    num_workers: int = 50        # m
    num_byzantine: int = 4       # q
    noise_std: float = 1.0
    rounds: int = 60             # O(log N)
    seed: int = 0


CONFIG = LinRegConfig()
