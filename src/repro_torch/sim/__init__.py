"""Adversarial scenario engine (PyTorch port of ``repro.sim``).

    from repro_torch import sim
    trace = sim.run_scenario("linreg/gmom/sign_flip/stealth_then_strike")

runs on the CUDA card; pass ``device="cpu"`` for the CPU.

The production-mesh counterpart is ``repro_torch.sim.sweep``: the same
attack × schedule × aggregator matrix bound to (arch, shape, mesh) triples
(``PodScenario``), each cell one rank's program traced on fake tensors on
the 16×16 / 2×16×16 meshes, its collective costs gated against the port's
record ``src/repro_torch/sim/pod_sweeps.json``
(``python -m repro_torch.sim.sweep --check``).
"""

from repro_torch.sim.engine import (  # noqa: F401
    build_schedule,
    restore_scenario_state,
    replay_scenario,
    run_failure_free,
    run_scenario,
)
from repro_torch.sim.scenarios import (  # noqa: F401
    Scenario,
    available,
    get_scenario,
    golden_scenarios,
    register,
)
from repro_torch.sim import goldens  # noqa: F401
