"""The Weiszfeld loop on the card (port of ``repro.kernels.geomed.ops``).

``geometric_median_kernel`` initialises at the weighted mean and steps
until the NORM of the move is <= ``tol`` (the reference's rule here,
unlike the squared move of the round kernels) or after ``max_iters``
steps.  On a CUDA tensor it takes one of two routes, by k alone
(``loop_route``):

* ``"device_loop"`` (k <= ``geomed.MAX_BATCHES``): the whole loop is one
  launch of ``geomed.weiszfeld_loop``; the stop is taken on the device;
* ``"step_kernels"`` (larger k, past the loop kernels' shared arrays):
  the host loops ``geomed.weiszfeld_step`` (the sqdist and reweight
  kernels) and reads the move back each iteration.

Each call counts in ``geometric_median_kernel.route_launches``.  A CPU
tensor runs the plain loop, and ``plain=True`` loops
``ref.weiszfeld_step_ref`` on any device.  ``geometric_median_blocked`` is
the twin of the loop kernels' arithmetic on a given grid, bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.geometric_median import f32_threshold
from repro_torch.kernels.geomed import geomed, ref
from repro_torch.kernels.geomed.twin import (block_moves, block_partials,
                                             fma_chain, reduce_partials,
                                             sequential, sqrt_rn,
                                             unit_partials)

ROUTES = ("device_loop", "step_kernels")


def loop_route(k: int) -> str:
    """The loop's route on the card, by k alone: one launch of the loop
    kernel for k <= ``geomed.MAX_BATCHES``, else the step kernels."""
    return "device_loop" if k <= geomed.MAX_BATCHES else "step_kernels"


def _geometric_median(points, weights=None, *, max_iters: int = 64,
                      tol: float = 1e-8, plain: bool = False):
    """``geometric_median_kernel`` with its iteration count: -> ((d,) f32,
    iterations as a 0-d int32 tensor on the input's device)."""
    k = points.shape[0]
    route = loop_route(k)
    on_card = not plain and points.device.type != "cpu"
    if on_card and route == "device_loop":
        out = geomed.weiszfeld_loop(points, weights, max_iters=max_iters,
                                    tol=tol)
    else:
        if weights is None:
            weights = torch.ones((k,), dtype=torch.float32,
                                 device=points.device)
        out = ref.geometric_median_ref(
            points, weights, max_iters=max_iters, tol=tol,
            step=geomed.weiszfeld_step if on_card else ref.weiszfeld_step_ref)
    if on_card:
        geometric_median_kernel.route_launches[route] += 1
    return out


def geometric_median_kernel(points, weights=None, *, max_iters: int = 64,
                            tol: float = 1e-8, plain: bool = False):
    """(1+gamma)-approximate geometric median of ``points`` (k, d) by
    Weiszfeld with the kernel-backed loop -> (d,) f32."""
    return _geometric_median(points, weights, max_iters=max_iters, tol=tol,
                             plain=plain)[0]


def reset_launches() -> None:
    """Zero ``geometric_median_kernel.route_launches``."""
    geometric_median_kernel.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()


def geometric_median_blocked(points, weights, *, n_blocks: int,
                             vec: int = 1, max_iters: int = 64,
                             tol: float = 1e-8, eps: float = 1e-12):
    """Plain PyTorch twin of the loop kernel for k points on a grid of
    ``n_blocks``, bit for bit: the init and each step as ``fma`` chains over
    the points in order, divided after the sum; the squared distances and
    the move as per-block partials reduced in ``reduce_partials``' order;
    the stop on the float32 square root of the move.  The partials follow
    the kernel ``geomed.loop_kernel(k)`` names: units of ``vec`` columns
    (``twin.unit_partials``) for ``"regs"``, tiles (``twin.block_partials``'
    resident and streamed orders) for ``"tiles"``.  CPU, float32 ->
    ((d,), iterations).
    """
    z = points.to(torch.float32).cpu()
    w = weights.to(torch.float32).cpu()
    k = z.shape[0]
    regs = geomed.loop_kernel(k) == "regs"

    def partials(e):                     # (r, d) -> (n_blocks, r)
        return (unit_partials(e, n_blocks, vec) if regs
                else block_partials(e, n_blocks))

    y = fma_chain((w[l], z[l]) for l in range(k)) / torch.clamp(
        sequential(list(w)), min=1e-12)
    part = partials(z - y)
    tol32, eps2 = f32_threshold(tol), f32_threshold(eps * eps)
    it = 0
    while it < max_iters:
        inv = w / sqrt_rn(reduce_partials(part) + eps2)
        denom = torch.clamp(sequential(list(inv)), min=eps)
        y_new = fma_chain((inv[l], z[l]) for l in range(k)) / denom
        move = reduce_partials(
            partials((y_new - y)[None, :]) if regs
            else block_moves(y_new - y, n_blocks)[:, None])[0]
        part = partials(z - y_new)
        y = y_new
        it += 1
        if not float(sqrt_rn(move)) > tol32:
            break
    return y, torch.tensor(it, dtype=torch.int32)
