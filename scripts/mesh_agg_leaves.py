#!/usr/bin/env python3
"""Which leaves of the model mesh's first aggregate stray from one
process's, on the card.

    PYTHONPATH=src python scripts/mesh_agg_leaves.py \
        [--arch zamba2-2.7b] [--cases bfloat16:0,bfloat16:1,float32:0]

Each case (the model's dtype and the seed of its params, tokens and attack
keys) runs ``chip_smoke.py`` phase 14 (e)'s first step: the arch at its
train depth and full width, remat, k = 4, q = 1, gmom under sign_flip,
AdamW; once in one process and once shard-local on a (2, 2) ("data",
"model") mesh of 4 rank processes of the card.  Prints one JSON line a
case with every leaf's ||mesh - one|| / ||one|| of the first aggregate
(largest first), the norm of each of those leaves, and the card's name
and power limit.  Exits 1 where a value is not finite.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))


def _rank(rank, world, device, arch, dname, seed):
    import torch
    import chip_smoke as cs
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import meshctx, model
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    mesh = mesh_lib.make_mesh(cs.FAMILY_MESHES["square"], ("data", "model"))
    cfg = cs.mesh_train_config(arch, dname)
    full = model.init(seed, cfg, device=dev)
    specs = sharding.param_shardings(full, mesh, cfg)
    stream = cs._mesh_train_stream(cfg, dev, seed)
    key = cs._mesh_train_key(dev, seed)
    g = cs.MESH_TRAIN
    with meshctx.set_mesh(mesh):
        res = cs._mesh_train_variant(
            cfg, mesh, "shard_local", full, specs, dev, 1,
            cs._mesh_train_rc(g["k"], g["q"], "auto"), optim.adamw(g["lr"]),
            stream.batch, lambda t: prng.fold_in(key, t), check_first=True)
    return res["first"].get("agg")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--cases", default="bfloat16:0,bfloat16:1,float32:0")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from torch.utils._pytree import keystr, tree_flatten_with_path
    from repro_torch.launch import ranks
    if not torch.cuda.is_available():
        print("mesh_agg_leaves: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    bad = False
    for case in args.cases.split(","):
        dname, seed = case.split(":")
        seed = int(seed)
        want = cs.mesh_train_reference(dev, "reference", 1, arch=args.arch,
                                       dname=dname, seed=seed)[3]
        torch.cuda.empty_cache()
        got = ranks.run(_rank, cs.MESH_RANKS, dev.type, args.arch, dname,
                        seed, timeout=900.0)[0]
        rel = cs._rel_norms(got, want, dev)
        norms = {keystr(p): float(t.float().norm())
                 for p, t in tree_flatten_with_path(want)[0]}
        order = sorted(rel, key=lambda n: -rel[n])
        bad = bad or not all(math.isfinite(v) for v in rel.values())
        print(json.dumps({
            "arch": args.arch, "dtype": dname, "seed": seed,
            "mesh": dict(zip(("data", "model"), cs.FAMILY_MESHES["square"])),
            "worst_rel_norm_err": rel[order[0]],
            "rel_norm_err_by_leaf": {n: rel[n] for n in order},
            "norm_by_leaf": {n: norms[n] for n in order}, "card": smi}),
            flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
