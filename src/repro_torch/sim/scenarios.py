"""Adversarial scenario registry (PyTorch port of ``repro.sim.scenarios``).

A ``Scenario`` pins every degree of freedom of one multi-round Byzantine
campaign on the paper's linear-regression testbed (§4): aggregator, attack,
multi-round schedule, the (m, q, k) fault geometry, the data dimensions and
a seed.  The registry is the reference's, name for name (all 29 linreg
campaigns).  ``golden=True`` marks the eleven goldens whose traces the
port keeps under ``sim/goldens/``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    # which substrate realizes the scenario; the engine runs "linreg"
    arch: str = "linreg"
    aggregator: str = "gmom"
    attack: str = "sign_flip"
    schedule: str = "rotating"
    attack_kwargs: tuple = ()        # tuple of (key, value) — hashable
    schedule_kwargs: tuple = ()
    compression: str = "none"
    arrival: str = "all_sync"
    staleness_bound: int = 0
    arrival_kwargs: tuple = ()       # tuple of (key, value) — hashable
    num_workers: int = 20            # m
    num_byzantine: int = 3           # q
    num_batches: int | None = 10     # k (None => paper's canonical choice)
    dim: int = 20                    # d
    total_samples: int = 4000        # N
    noise_std: float = 1.0
    rounds: int = 40                 # O(log N) per the paper
    step_size: float = 0.5           # eta = L/(2M^2) = 1/2 for linreg
    seed: int = 0
    golden: bool = False             # trace kept under sim/goldens/

    @property
    def paper_floor(self) -> float:
        """The paper's headline error scale sqrt(d (2q+1) / N)."""
        return math.sqrt(self.dim * (2 * self.num_byzantine + 1)
                         / self.total_samples)


_REGISTRY: dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    if sc.name in _REGISTRY:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _REGISTRY[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def golden_scenarios() -> list[Scenario]:
    return [sc for _, sc in sorted(_REGISTRY.items()) if sc.golden]


def _n(agg, attack, schedule) -> str:
    return f"linreg/{agg}/{attack}/{schedule}"


# ---------------------------------------------------------------------------
# the registry

# Headline claim (Theorem 1 / Corollary 1): GMoM converges under EVERY
# attack × schedule while 2(1+eps)q <= k — the adversary's round-to-round
# adaptivity ("arbitrary and unspecified dependency among the iterations")
# buys it nothing.
for _attack in ("sign_flip", "zero", "random_noise", "inner_product",
                "mean_shift", "alie", "norm_stealth"):
    for _schedule in ("static", "rotating"):
        register(Scenario(name=_n("gmom", _attack, _schedule),
                          attack=_attack, schedule=_schedule))

for _schedule in ("ramp_up", "coordinated_switch", "stealth_then_strike"):
    register(Scenario(name=_n("gmom", "sign_flip", _schedule),
                      schedule=_schedule))

# Algorithm 1 (mean) baseline: breaks under a single adversarial round,
# converges failure-free.
register(Scenario(name=_n("mean", "sign_flip", "rotating"),
                  aggregator="mean"))
register(Scenario(name=_n("mean", "none", "static"), aggregator="mean",
                  attack="none", schedule="static", num_byzantine=0,
                  num_batches=1))

# Related-work baselines (Yin et al. '18 trimmed mean; BMGS17 Krum; k=m
# geomed) against both a classic large-norm attack and the small-norm ALIE.
for _agg in ("trimmed_mean", "coordinate_median", "krum", "geomed"):
    for _attack in ("sign_flip", "alie"):
        register(Scenario(name=_n(_agg, _attack, "rotating"),
                          aggregator=_agg, attack=_attack))

# Communication-compressed campaign (Jin et al. '19 signSGD majority vote):
# workers report 1-bit packed sign words and the server votes on the wire
# payload.  Sign steps have unit per-coordinate magnitude, so the step size
# drops to keep the sign-descent error floor (~ eta sqrt(d)) small.
register(Scenario(name="linreg/sign_majority_static",
                  aggregator="sign_sgd_majority", attack="sign_flip",
                  schedule="static", compression="sign",
                  step_size=0.05, golden=True))

# Bounded-staleness campaign: a rotating random straggler pair delivers up
# to τ=2-round-old buffered gradients while the rotating sign_flip
# colluders stay live.  Its trace carries the per-round stale_count.
register(Scenario(name=_n("gmom", "sign_flip", "rotating") + "/stale",
                  arrival="straggler_rotating", staleness_bound=2,
                  golden=True))

# Checked-in golden traces: one per schedule family plus the mean baselines
# and one related-work aggregator — compact but covers every code path.
_GOLDEN = (
    _n("gmom", "sign_flip", "rotating"),
    _n("gmom", "alie", "static"),
    _n("gmom", "norm_stealth", "rotating"),
    _n("gmom", "sign_flip", "ramp_up"),
    _n("gmom", "sign_flip", "coordinated_switch"),
    _n("gmom", "sign_flip", "stealth_then_strike"),
    _n("mean", "sign_flip", "rotating"),
    _n("mean", "none", "static"),
    _n("trimmed_mean", "alie", "rotating"),
)
for _name in _GOLDEN:
    _REGISTRY[_name] = dataclasses.replace(_REGISTRY[_name], golden=True)
