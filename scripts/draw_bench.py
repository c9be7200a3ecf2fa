#!/usr/bin/env python3
"""The port's threefry draws on the card against an earlier tree's.

    PYTHONPATH=src python scripts/draw_bench.py --baseline DIR

DIR is a checkout of an earlier tree; its ``src/repro_torch/random.py``
is loaded beside this tree's as a module of its own.  At each size (a
paper-width report, a wide one, a batch of audio frames, an LM leaf)
the same key draws ``bits``, ``uniform`` and ``normal`` through both, in
turns (baseline, this tree, this tree, baseline), each the median of
``--reps`` synchronised calls after a warm-up; the bits must be equal.
This tree's ``uniform_at`` at a quarter of the indices (a rank's block
of 4) is timed beside.  Prints one JSON line a size with the card's
name and power limit; exits 1 on any difference.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

SIZES = (50, 409_600, 2_097_152 * 8, 123_000_000)


def _baseline_random(root: Path):
    spec = importlib.util.spec_from_file_location(
        "baseline_random", root / "src" / "repro_torch" / "random.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch
    from repro_torch import random as prng
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--baseline", required=True, type=Path)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("draw_bench: CUDA is not available", file=sys.stderr)
        return 1
    base = _baseline_random(args.baseline)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    ok = True
    for n in SIZES:
        key = prng.PRNGKey(n % 1000, device=dev)
        row = {"n": n, "card": smi}
        reps = args.reps if n < 10_000_000 else 3
        for name in ("bits", "uniform", "normal"):
            ours, theirs = getattr(prng, name), getattr(base, name)
            same = torch.equal(ours(key, (n,)), theirs(key, (n,)))
            ok = ok and same
            a = _ms(lambda: theirs(key, (n,)), reps)
            b = _ms(lambda: ours(key, (n,)), reps)
            c = _ms(lambda: ours(key, (n,)), reps)
            d = _ms(lambda: theirs(key, (n,)), reps)
            row[name] = {"baseline_ms": [a, d], "ms": [b, c], "equal": same}
        idx = torch.arange(0, n, 4, device=dev)
        row["uniform_at_quarter_ms"] = _ms(
            lambda: prng.uniform_at(key, (n,), idx), reps)
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
