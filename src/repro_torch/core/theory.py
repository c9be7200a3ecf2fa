"""Closed-form quantities from the paper's theory (port of
``repro.core.theory``, pure Python).

Used by tests and benchmarks to check the implementation against the paper's
own claims (convergence rate, error floor, tolerance region) rather than
against ad-hoc numbers.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Assumption 1 constants of the population risk F."""
    strong_convexity: float      # L
    lipschitz_gradient: float    # M

    @property
    def step_size(self) -> float:
        """The paper's canonical eta = L / (2 M^2)."""
        L, M = self.strong_convexity, self.lipschitz_gradient
        return L / (2.0 * M * M)

    @property
    def population_contraction(self) -> float:
        """Per-step factor of exact population GD (Lemma 3):
        sqrt(1 - L^2/(4 M^2))."""
        L, M = self.strong_convexity, self.lipschitz_gradient
        return math.sqrt(1.0 - L * L / (4.0 * M * M))

    @property
    def theorem1_contraction(self) -> float:
        """Theorem 1/5 rate: 1/2 + 1/2 sqrt(1 - L^2/4M^2)."""
        return 0.5 + 0.5 * self.population_contraction

    def rho(self, xi2: float) -> float:
        """Lemma 4's rho = 1 - sqrt(1-L^2/4M^2) - xi2 L/(2M^2)."""
        return 1.0 - self.population_contraction - xi2 * self.step_size


# Linear regression (paper §4): F(theta)=0.5||theta-theta*||^2 + 0.5
LINEAR_REGRESSION = ProblemConstants(strong_convexity=1.0,
                                     lipschitz_gradient=1.0)
# => eta = 1/2, contraction 1/2 + sqrt(3)/4 ≈ 0.933 (Corollary 1).


def c_alpha(alpha: float) -> float:
    """Lemma 1's C_alpha = 2(1-alpha)/(1-2alpha)."""
    if not 0.0 <= alpha < 0.5:
        raise ValueError("alpha must be in [0, 1/2)")
    return 2.0 * (1.0 - alpha) / (1.0 - 2.0 * alpha)


def tolerance_ok(num_workers: int, num_batches: int, num_byzantine: int, *,
                 epsilon: float = 0.1) -> bool:
    """Tolerance condition 2(1+eps) q <= k <= m (Theorem 1)."""
    return (2.0 * (1.0 + epsilon) * num_byzantine <= num_batches
            <= num_workers)


def error_floor(dim: int, total_samples: int, num_batches: int, *,
                alpha: float = 0.3, c2: float = 1.0) -> float:
    """Theorem 5 floor  c2 * C_alpha * sqrt(d k / N)  (up to the universal
    constant c2, which benchmarks fit empirically)."""
    return c2 * c_alpha(alpha) * math.sqrt(dim * num_batches / total_samples)


def binary_divergence(p: float, q: float) -> float:
    """D(p || q) for Bernoulli — appears in the success probability bound."""
    if p in (0.0, 1.0):
        return (math.log(1.0 / q) if p == 1.0 else math.log(1.0 / (1.0 - q)))
    return p * math.log(p / q) + (1 - p) * math.log((1 - p) / (1 - q))


def success_probability_lower_bound(num_batches: int, num_byzantine: int,
                                    alpha: float, delta: float) -> float:
    """1 - exp(-k D(alpha - q/k || delta)) from Theorem 1."""
    gap = alpha - num_byzantine / num_batches
    if gap <= delta:
        return 0.0
    return 1.0 - math.exp(-num_batches * binary_divergence(gap, delta))
