"""repro_torch — the PyTorch/CUDA port of ``repro`` (Byzantine Gradient
Descent, Chen, Su, Xu 2017) for one NVIDIA H100.

The layout mirrors ``repro``: each module's reference is the module of the
same name there.  This package never imports ``jax`` or ``repro``; the
parity tests are the only code that imports both.

Subpackages:
    core        grouping, geometric median, aggregators, attacks, training
    kernels     hand-written CUDA kernels for Hopper (sm_90a), built by nvcc
                (the GMoM family and flash attention)
    data        the paper's linear-regression data model
    optim       SGD and learning-rate schedules
    checkpoint  msgpack/npz checkpoints, layout-compatible with ``repro``
    sim         scenario registry, engine and golden traces
    configs     model configs (the dense family) and input shapes
    models      the dense GQA decoder: layers, attention, blocks, model
    launch      prefill/serve steps and the serve CLI

Entry points (``sim.run_scenario``, ``sim.replay_scenario``,
``core.robust_train.make_run_rounds``, ``data.regression.generate``,
``models.model.init``, ``models.model.init_decode_state``,
``launch.serve``) run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
