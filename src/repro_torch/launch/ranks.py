"""Local rank processes joined in one ``torch.distributed`` group.

The port's stand-in for a device mesh on one host (the reference fakes
one with ``--xla_force_host_platform_device_count``):
``run(fn, world_size, *args)`` starts ``world_size`` processes with the
``spawn`` start method (which CUDA needs), joins them in one gloo group
through a ``file://`` rendezvous in a fresh temporary directory (no TCP
port to clash with another run), calls ``fn(rank, world_size, *args)`` in
each and returns the results in rank order, loaded on the CPU.

The arguments reach the ranks through one file in that directory, not
through the spawn pipe: the parent would block on each child's pipe
until the child had imported its modules, so large arguments would start
the ranks one after another.

``fn`` must be importable by its module path (a top-level function).  Each
rank runs with the caller's ``torch.get_num_threads()``, so its CPU
reductions split as the caller's do, and gloo binds the loopback device
unless ``GLOO_SOCKET_IFNAME`` says otherwise; a model mesh's collectives
go through files in the temporary directory instead
(``models.meshctx.use_local_transport``).  A rank that raises or exits
non-zero fails the call at once, as does a call that outlives ``timeout``;
every process is stopped before ``run`` returns or raises.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.models import meshctx


def _rank_main(fn, rank: int, world_size: int, rendezvous: str, out: str,
               threads: int, args_file: str) -> None:
    torch.set_num_threads(threads)
    args = torch.load(args_file, weights_only=False)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world_size)
    meshctx.use_local_transport(os.path.dirname(rendezvous))
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


def run(fn, world_size: int, *args, timeout: float = 600.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` ranks; their
    results in rank order."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        args_file = os.path.join(tmp, "args.pt")
        torch.save(args, args_file)
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, os.path.join(tmp, "rendezvous"),
                  outs[r], torch.get_num_threads(), args_file))
            for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in running]} still "
                        f"running after {timeout} s")
                for sentinel in mp.connection.wait(
                        [p.sentinel for p in running], left):
                    p = next(q for q in running if q.sentinel == sentinel)
                    p.join()
                    if p.exitcode != 0:
                        raise RuntimeError(
                            f"rank {procs.index(p)} of {world_size} exited "
                            f"with code {p.exitcode}")
                    running.remove(p)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
        return [torch.load(out, map_location="cpu", weights_only=False)
                for out in outs]
