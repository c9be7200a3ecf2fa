"""Rank bodies of the dry run's tests against real runs.

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  ``dry_vs_real`` builds
the mesh of ``shape`` over ``axes`` on the ranks and, for each case, runs
the step for real on the CPU (the group train step in either variant,
the prefill step, the serve step) under ``FlopCounterMode``, and then the
dry run of the same step (``launch.dryrun.lower_pair``) on this rank's
abstract view of the mesh, on fake "cpu" tensors; it returns both
records: the collectives by kind (``Mesh.stats["kinds"]``), the bytes
received by group, and the dot FLOPs.

The real run builds its inputs as the dry run does: the full params
(drawn from a seed, every rank the same) cut to the storage blocks
(``sharding.storage_params``), the batch cut to the rank's block; the
prefill and the serve step take the compute layout gathered from the
storage blocks (``sharding.compute_params``), as the dry run does.  Its
Weiszfeld loops run with ``gmom_tol`` 0, so they stop only at the cap,
where the dry run's stop also lies (``_device.host_value``); the real
run's count of stop reads is returned to show it.

A case with ``sweep`` names a cell of the pod sweep
(``repro_torch.sim.sweep``): a train-step cell runs the group step built
from its ``PodScenario.robust_config()`` (the stop at the cap only) and
``build_schedule()``, at the case's reduced config and shape; a
microcell (the report wire, the staleness merge) runs its rank program
on the rank's column block of a report of ``d`` coordinates drawn from a
seed with numpy (``sweep.run_microcell``), and returns its outputs
beside the counts.

A case with ``fault`` "direct_gather" runs the real step with
``core.shard_aggregation.all_gather`` taken back to a direct
``dist.all_gather`` on the group (the same bits, outside the mesh's
transport), so that its counts miss the layout's blocked-sum gathers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _device, configs, optim
from repro_torch import random as prng
from repro_torch.configs.base import InputShape
from repro_torch.core import shard_aggregation as sa
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import meshctx
from repro_torch.models import model as model_lib
from repro_torch.sim import sweep

OVERRIDES = {"granite-moe-1b-a400m": {"moe_capacity_factor": 8.0}}


def config(arch):
    return configs.get_config(arch).reduced().with_(
        **OVERRIDES.get(arch, {}))


def train_rc(k: int):
    """``dryrun.default_train_rc`` with the stop at the cap only."""
    return dataclasses.replace(dryrun.default_train_rc(k), gmom_tol=0.0)


def _direct_all_gather(x, group=None):
    """``shard_aggregation.all_gather`` as it was before it went through
    the mesh: straight to ``dist.all_gather`` on the group."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _tokens(cfg, shape, lead, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, lead, generator=g,
                         dtype=torch.int32)


def _real(case, mesh, cfg, shape):
    """The step of ``case`` for real on this rank: (kinds, groups, dot
    FLOPs, stop reads)."""
    k = case.get("k", 4)
    full = model_lib.init(case.get("seed", 0), cfg, device="cpu")
    specs = sharding.param_shardings(full, mesh, cfg)
    storage = sharding.cut_tree(full, specs, mesh)
    reads = [0]
    real_read = _device.host_value

    def counted(t, *, traced):
        reads[0] += 1
        return real_read(t, traced=traced)

    B, T = shape.global_batch, shape.seq_len
    with meshctx.set_mesh(mesh):
        if shape.kind == "train":
            opt = optim.adamw(3e-4)
            opt_state = opt.init(storage)
            tok = _tokens(cfg, shape, (k, B // k, T), 11)
            batch = sharding.local_train_batch(
                {"tokens": tok, "labels": tok.roll(-1, -1)}, mesh, cfg)
            if case["variant"] == "gathered":
                gshard = sharding.gathered_grad_shardings(storage, mesh)
                spec = dataclasses.replace(
                    sharding.grad_shard_spec(mesh, cfg), num_shards=1)
            else:
                gshard = sharding.stacked_grad_shardings(full, mesh, cfg)
                spec = sharding.grad_shard_spec(mesh, cfg)
            ps = (sweep.get_pod_scenario(case["sweep"]) if "sweep" in case
                  else None)
            schedule = ps.build_schedule() if ps is not None else None
            rc = sweep.capped_rc(ps) if ps is not None else train_rc(k)
            step = steps.make_group_train_step(
                cfg, rc, opt,
                microbatches=case["microbatches"], grad_shardings=gshard,
                shard_spec=spec, param_shardings=specs, schedule=schedule)
            key = prng.PRNGKey(0)
            extra = (() if schedule is None
                     else (schedule.init_state(torch.device("cpu")),))

            def run():
                return step(storage, opt_state, batch, key, 0, *extra)
        elif shape.kind == "prefill":
            batch = sharding.local_batch(
                {"tokens": _tokens(cfg, shape, (B, T), 12)}, mesh, cfg)
            plans = sharding.compute_plans(storage, specs, mesh, cfg,
                                           batch=B, seq=T)
            step = steps.make_prefill_step(cfg)

            def run():
                return step(sharding.compute_params(storage, plans, mesh),
                            batch)
        else:
            state = sharding.local_decode_state(
                model_lib.init_decode_state(cfg, B, T, device="cpu"), mesh,
                cfg, B)
            rows = sharding.local_rows(_tokens(cfg, shape, (B, 1), 13), mesh)
            pos = sharding.local_rows(torch.full((B,), 3, dtype=torch.int32),
                                      mesh)
            plans = sharding.compute_plans(storage, specs, mesh, cfg,
                                           batch=B, seq=1)
            step = steps.make_serve_step(cfg)

            def run():
                return step(sharding.compute_params(storage, plans, mesh),
                            state, rows, pos)
        del full
        direct = case.get("fault") == "direct_gather"
        if direct:
            sa.all_gather = _direct_all_gather
        _device.host_value = counted
        try:
            mesh.reset_stats()
            with FlopCounterMode(display=False) as flops:
                run()
        finally:
            _device.host_value = real_read
            if direct:
                sa.all_gather = _REAL_ALL_GATHER
    return (mesh.stats["kinds"], mesh.stats["groups"],
            flops.get_total_flops(), reads[0])


_REAL_ALL_GATHER = sa.all_gather


def _real_microcell(case, mesh):
    ps = sweep.get_pod_scenario(case["sweep"])
    mesh.reset_stats()
    with meshctx.set_mesh(mesh), FlopCounterMode(display=False) as flops:
        out = sweep.run_microcell(ps, mesh, case["d"], case["seed"],
                                  rc=sweep.capped_rc(ps), device="cpu")
    return (mesh.stats["kinds"], mesh.stats["groups"],
            flops.get_total_flops(), out)


def dry_vs_real(rank, world, shape, axes, cases):
    """Each case of ``cases`` on this rank of the (``shape``, ``axes``)
    mesh, real and dry -> [{"real": ..., "dry": ..., "reads": n}] (a
    microcell's with its ``outputs``)."""
    torch.manual_seed(0)
    mesh = mesh_lib.make_mesh(shape, axes)
    out = []
    for case in cases:
        if "d" in case:
            kinds, groups, flops, outputs = _real_microcell(case, mesh)
            rec = sweep.trace_microcell(
                sweep.get_pod_scenario(case["sweep"]),
                mesh=mesh_lib.make_mesh(shape, axes, rank=rank),
                d_pad=case["d"], device="cpu").record
            out.append({"real": {"kinds": kinds, "groups": groups,
                                 "flops": flops},
                        "dry": _dry_counts(rec), "outputs": outputs,
                        "seconds": rec.trace_seconds})
            continue
        cfg = config(case["arch"])
        ishape = InputShape(**case["shape"])
        kinds, groups, flops, reads = _real(case, mesh, cfg, ishape)
        res = {"real": {"kinds": kinds, "groups": groups, "flops": flops},
               "reads": reads}
        if not case.get("fault"):
            ps = (sweep.get_pod_scenario(case["sweep"]) if "sweep" in case
                  else None)
            art = dryrun.lower_pair(
                cfg, ishape, mesh=mesh_lib.make_mesh(shape, axes, rank=rank),
                num_groups=case.get("k", 4),
                microbatches=case.get("microbatches", 1),
                rc=(ps.robust_config() if ps is not None
                    else train_rc(case.get("k", 4))),
                schedule=ps.build_schedule() if ps is not None else None,
                gather_grads=case.get("variant") == "gathered",
                device="cpu", verbose=False)
            res["dry"] = _dry_counts(art.record)
            res["seconds"] = art.trace_seconds
        out.append(res)
    return out


def _dry_counts(rec):
    return {"kinds": rec.collective_breakdown,
            "groups": {g: v["wire_bytes"]
                       for g, v in rec.collective_groups.items()},
            "flops": int(rec.flops_per_device)}
