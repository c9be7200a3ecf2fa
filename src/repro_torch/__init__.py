"""repro_torch — the PyTorch/CUDA port of ``repro`` (Byzantine Gradient
Descent, Chen, Su, Xu 2017) for one NVIDIA H100.

The layout mirrors ``repro``: each module's reference is the module of the
same name there.  This package never imports ``jax`` or ``repro``; the
parity tests are the only code that imports both.

Subpackages:
    core        grouping, geometric median, aggregators, attacks, training
    kernels     hand-written CUDA kernels for Hopper (sm_90a), built by nvcc
    data        the paper's linear-regression data model
    optim       SGD and learning-rate schedules
    checkpoint  msgpack/npz checkpoints, layout-compatible with ``repro``
    sim         scenario registry, engine and golden traces

Entry points (``sim.run_scenario``, ``sim.replay_scenario``,
``core.robust_train.make_run_rounds``, ``data.regression.generate``) run
on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
