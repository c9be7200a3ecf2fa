"""Adversarial scenario engine (PyTorch port of ``repro.sim``).

    from repro_torch import sim
    trace = sim.run_scenario("linreg/gmom/sign_flip/stealth_then_strike")

runs on the CUDA card; pass ``device="cpu"`` for the CPU.
"""

from repro_torch.sim.engine import (  # noqa: F401
    build_schedule,
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
