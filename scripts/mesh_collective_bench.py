#!/usr/bin/env python3
"""ms per collective of the model mesh on local rank processes, over gloo
and through the local transport's mapped file.

    PYTHONPATH=src python scripts/mesh_collective_bench.py [--device cuda]

Four ranks (``launch.ranks.run``) form a (1, 4) mesh and time
``meshctx._parts`` (the all-gather under every psum and gather) and
``meshctx._psum_scatter`` (its all-to-all) on bf16 tensors of each size in
``SIZES``: a decode step's (4 requests of a 2880-wide row, 23 KB) and a
sequence-parallel prefill's (16 MB); on the card each call stages the
tensor through the host and back.  A rank runs each case twice, over the
gloo group (``meshctx.use_local_transport(None)``) and through the file,
and checks that both gather the same bytes.  Prints one JSON line a case
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

# bytes of the timed tensor: calls a case
SIZES = {23040: 200, 16 << 20: 10}


def _rank(rank, world, device, nbytes, calls):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import meshctx
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(rank)
    x = torch.randn(nbytes // 2, generator=gen, device=dev).to(
        torch.bfloat16)
    local_dir = meshctx._LOCAL_DIR
    mesh = mesh_lib.make_mesh((1, world), ("data", "model"))
    out, gathered = {}, {}
    with meshctx.set_mesh(mesh):
        for transport in ("gloo", "file"):
            meshctx.use_local_transport(
                None if transport == "gloo" else local_dir)
            for kind in ("all_gather", "psum_scatter"):
                def call():
                    if kind == "all_gather":
                        return meshctx._parts(x, mesh, ("model",))
                    return meshctx._psum_scatter(x, mesh, ("model",), 0)
                for _ in range(3):
                    y = call()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(calls):
                    y = call()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out[f"{transport}_{kind}_ms"] = (
                    (time.perf_counter() - t0) * 1e3 / calls)
                if kind == "all_gather":
                    gathered[transport] = y.cpu()
    out["same_bytes"] = bool(torch.equal(gathered["gloo"], gathered["file"]))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    from repro_torch.launch import ranks
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    ok = True
    for nbytes, calls in SIZES.items():
        res = ranks.run(_rank, 4, args.device, nbytes, calls, timeout=600)
        ok &= all(r["same_bytes"] for r in res)
        print(json.dumps({"bytes": nbytes, "calls": calls, "ranks": 4,
                          "device": args.device, "card": card,
                          "by_rank": res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
