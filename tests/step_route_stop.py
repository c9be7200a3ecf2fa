"""Where the Weiszfeld loop over the step kernels stops, on the card, with
each step kernel or its plain version: which summation order makes the
loop settle into a cycle instead of a fixed point.

The loop is the step route of ``ops.geometric_median_kernel`` (k past the
loop kernels' 64): init at the mean, then sqdist, the O(k) glue and
reweight until the norm of the move is <= tol (1e-8) or 64 steps.  It is
run four ways on the same inputs:

* ``kernels``: ``geomed.sqdist`` and ``geomed.reweight`` (the route);
* ``plain_sqdist``: ``ref.weiszfeld_distances_ref`` and the reweight kernel;
* ``plain_reweight``: the sqdist kernel and ``ref.weiszfeld_reweight_ref``;
* ``plain``: both plain versions (``plain=True``).

Inputs are ``chip_smoke.py``'s ``geomed_inputs`` (points ~ N(0, 1) + 1
from a torch generator on the device, unit weights); the default seeds
are the chip check's at (100, 1 000 000) and 0-7.  One JSON line per
input and variant: the iterations, the last moves, and at the cap whether
the iterates repeat with period 2 and in how many coordinates the last
two differ.  It uses only what every slice of the port's ``geomed``
offers, so the same script measures an older tree:

    PYTHONPATH=src python tests/step_route_stop.py --label change
    PYTHONPATH=<older tree>/src python tests/step_route_stop.py --label parent

Not a test (pytest does not collect it); it needs the card.
"""

import argparse
import json

import torch

from repro_torch.core.geometric_median import f32_threshold
from repro_torch.kernels.geomed import geomed, ref

CAP, TOL, EPS = 64, 1e-8, 1e-12


def inputs(k, d, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((k, d), generator=gen, device=dev) + 1.0


def run(z, sqdist, reweight):
    """The step route's loop with the given step functions -> (iterations,
    moves, the last three iterates)."""
    k = z.shape[0]
    w = torch.ones((k,), dtype=torch.float32, device=z.device)
    y = (w @ z) / torch.clamp(torch.sum(w), min=1e-12)
    it, delta, moves, last = 0, float("inf"), [], [y]
    while it < CAP and delta > f32_threshold(TOL):
        inv = w / torch.sqrt(sqdist(z, y) + EPS * EPS)
        denom = torch.clamp(torch.sum(inv), min=EPS)
        y_new = reweight(z, inv) / denom
        delta = float(torch.linalg.norm(y_new - y))
        moves.append(delta)
        y = y_new
        last = (last + [y])[-3:]
        it += 1
    return it, moves, last


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="change")
    p.add_argument("--shape", type=int, nargs=2, default=(100, 1_000_000))
    p.add_argument("--seeds", type=int, nargs="*",
                   default=[509, *range(8)])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    dev = torch.device(a.device)
    k, d = a.shape
    variants = {
        "kernels": (geomed.sqdist, geomed.reweight),
        "plain_sqdist": (ref.weiszfeld_distances_ref, geomed.reweight),
        "plain_reweight": (geomed.sqdist, ref.weiszfeld_reweight_ref),
        "plain": (ref.weiszfeld_distances_ref, ref.weiszfeld_reweight_ref),
    }
    for seed in a.seeds:
        z = inputs(k, d, seed, dev)
        for name, (sq, rw) in variants.items():
            it, moves, last = run(z, sq, rw)
            row = {"label": a.label, "shape": [k, d], "seed": seed,
                   "variant": name, "iters": it,
                   "last_moves": moves[-4:]}
            if it == CAP:
                row["period_2"] = bool(torch.equal(last[-1], last[-3]))
                row["coords_moving"] = int((last[-1] != last[-2]).sum())
            print(json.dumps(row), flush=True)
        del z
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
