"""The Weiszfeld loop over the step kernels (port of
``repro.kernels.geomed.ops``).

``geometric_median_kernel`` initialises at the weighted mean and loops
``geomed.weiszfeld_step`` (the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor); ``plain=True`` loops ``ref.weiszfeld_step_ref``
instead.  It stops when the NORM of the move is <= ``tol`` (the reference's
rule here, unlike the squared move of the round kernels) or after
``max_iters`` steps; the test reads one scalar back per iteration.
"""

from __future__ import annotations

import torch

from repro_torch.core.geometric_median import f32_threshold
from repro_torch.kernels.geomed import geomed, ref


def geometric_median_kernel(points, weights=None, *, max_iters: int = 64,
                            tol: float = 1e-8, plain: bool = False):
    """(1+gamma)-approximate geometric median of ``points`` (k, d) by
    Weiszfeld with the kernel-backed step -> (d,) f32."""
    k = points.shape[0]
    if weights is None:
        weights = torch.ones((k,), dtype=torch.float32, device=points.device)
    weights = weights.to(torch.float32)
    step = ref.weiszfeld_step_ref if plain else geomed.weiszfeld_step
    w_sum = torch.clamp(torch.sum(weights), min=1e-12)
    y = (weights @ points.to(torch.float32)) / w_sum
    it, delta = 0, float("inf")
    while it < max_iters and delta > f32_threshold(tol):
        y_new = step(points, y, weights)
        delta = float(torch.linalg.norm(y_new - y))
        y = y_new
        it += 1
    return y
