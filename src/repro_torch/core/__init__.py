"""Core library: the paper's Byzantine Gradient Descent in PyTorch.

Public API (the port's part of ``repro.core``'s):
    geometric_median, geometric_median_pytree, trim_weights,
    batch_mean_norms, weiszfeld_step
    aggregators.get_aggregator / available
    byzantine.get_attack / available / sample_byzantine_mask
    RobustConfig, make_robust_train_step, make_run_rounds,
    per_worker_grads, aggregate, aggregate_reported
    TrainState, init_train_state, advance, save/restore_train_state
    grouping.make_grouping / choose_num_batches
"""

from repro_torch.core.geometric_median import (  # noqa: F401
    batch_mean_norms,
    geometric_median,
    geometric_median_pytree,
    trim_weights,
    weiszfeld_step,
)
from repro_torch.core import aggregators, byzantine, grouping  # noqa: F401
from repro_torch.core.robust_train import (  # noqa: F401
    RobustConfig,
    aggregate,
    aggregate_reported,
    make_robust_train_step,
    make_run_rounds,
    per_worker_grads,
    schedule_from_config,
)
from repro_torch.core.train_state import (  # noqa: F401
    TrainState,
    advance,
    append_history,
    init_train_state,
    restore_train_state,
    save_train_state,
)
