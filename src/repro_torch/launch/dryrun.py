"""Pod dry run: one rank's step of every (architecture × input shape) on
the production meshes, traced on fake tensors (port of
``repro.launch.dryrun``).

The reference lowers and compiles one SPMD program with 512 placeholder
host devices and reads the per-device costs of its partitioned HLO.  The
port has no SPMD compiler: each rank runs its own program, with the
collectives placed by hand.  So the dry run runs ONE rank's program (rank
0 by default, any rank on request) under ``FakeTensorMode`` on the device
it would use (``cuda`` by default, which needs no card), on that rank's
view of the mesh (``Mesh.abstract``: no process group, a transport that
moves no bytes), and counts three things: every op's work and bytes and
the live device bytes (``roofline.counter.Counter``), and every
collective by kind (``Mesh.stats``).  The step is the real one: the
group-mode robust train step (train_4k; shard-local, or gathered with
``gather_grads=True``, which reaches the round kernel's op), the prefill
step (prefill_32k; the flash kernel's op at the rank's query offset) or
the single-token serve step (decode_32k, long_500k), from the rank's
storage blocks (``sharding.storage_params``) of the abstract params, its
optimizer state, and its block of the abstract batch or decode state
(``steps.input_specs``).  A loop whose stop reads the data runs to its
cap (``_device.host_value``), as the reference's parser takes a while
loop's static bound.  The reference's ``force_host_device_count`` has no
counterpart: a fake trace needs no devices.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]

A pair the port refuses by name (a decode layout of ROADMAP Queue 1 item
16.17) is listed with its refusal; ``--all`` exits 1 when any pair
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import _device, optim
from repro_torch.configs import ARCHITECTURES
from repro_torch.configs.base import ModelConfig
from repro_torch.core import RobustConfig, byzantine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import meshctx
from repro_torch.roofline import analysis
from repro_torch.roofline.counter import Counter

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


@dataclasses.dataclass
class DryrunArtifacts:
    """Everything one rank's traced step produces: the record, and the
    counter's per-op log (name -> calls, bytes, FLOPs) in place of the
    reference's lowered and compiled programs."""
    arch: str
    shape_name: str
    mesh_name: str
    step_kind: str
    num_chips: int
    cfg: ModelConfig
    shape: object
    record: analysis.RooflineRecord
    ops: dict
    trace_seconds: float


def default_train_rc(num_groups: int) -> RobustConfig:
    """The historical dry-run aggregation config (gmom + sign_flip)."""
    return RobustConfig(num_workers=num_groups, num_byzantine=1,
                        num_batches=num_groups, aggregator="gmom",
                        attack="sign_flip", gmom_max_iters=8)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def lower_pair(arch_or_cfg, shape_name, *, multi_pod: bool = False,
               mesh=None, rank: int = 0, num_groups: int = 4,
               microbatches: int = 1, fsdp: bool = True,
               rc: RobustConfig | None = None,
               schedule: byzantine.AttackSchedule | None = None,
               gather_grads: bool = False, device: str = "cuda",
               verbose: bool = True) -> DryrunArtifacts:
    """Trace one rank's step of (arch, shape) on ``mesh`` (default: rank
    ``rank``'s view of the production mesh) and return its artifacts;
    ``shape_name`` names a shape of the table or is an ``InputShape``.

    ``rc`` and ``schedule`` configure the group train step (train shapes
    only; default gmom + sign_flip), AdamW at 3e-4 as the reference's.
    ``gather_grads=True`` traces the gathered baseline: the stacked
    gradients gathered whole before the attack and the aggregation (the
    round kernel's op on the card), with a spec of ``num_shards`` 1;
    default False keeps them on the 2D layout, shard-local.  ``device``
    is the device the rank would use (``cuda``: no card needed)."""
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, rank=rank)
    if not mesh.is_abstract:
        raise ValueError("the dry run traces one rank's view of a mesh "
                         "(Mesh.abstract, launch.mesh's rank=)")
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    dev, routed = _device.trace_device(_device.traced(device))
    cfg, shape, batch = steps.input_specs(
        arch_or_cfg, shape_name, num_groups=num_groups, mode=mode,
        device=dev)
    arch = arch_or_cfg if isinstance(arch_or_cfg, str) else cfg.name
    shape_name = shape.name
    counter = Counter(device=dev.type)
    t0 = time.perf_counter()
    with mode, _device.route_as(routed), meshctx.set_mesh(mesh):
        full = steps.abstract_params(cfg, mode=mode, device=dev)
        specs = sharding.param_shardings(full, mesh, cfg, fsdp=fsdp)
        storage = sharding.cut_tree(full, specs, mesh)
        del full
        extra = dict(params_bytes=_nbytes(storage))
        if shape.kind == "train":
            if rc is None:
                rc = default_train_rc(num_groups)
            opt = optim.adamw(3e-4)
            opt_state = opt.init(storage)
            local = sharding.local_train_batch(batch, mesh, cfg)
            if gather_grads:
                gshard = sharding.gathered_grad_shardings(storage, mesh)
                spec = dataclasses.replace(
                    sharding.grad_shard_spec(mesh, cfg), num_shards=1)
            else:
                gshard = sharding.stacked_grad_shardings(
                    sharding.param_shapes(cfg), mesh, cfg, fsdp=fsdp)
                spec = sharding.grad_shard_spec(mesh, cfg)
            step_fn = steps.make_group_train_step(
                cfg, rc, opt, microbatches=microbatches,
                grad_shardings=gshard, schedule=schedule, shard_spec=spec,
                param_shardings=specs)
            # the key's struct (the port keeps a key as two int64 words): a
            # fake trace never reads its value
            key = torch.empty((2,), dtype=torch.int64, device=dev)
            args = [storage, opt_state, local, key, 0]
            if schedule is not None:
                args.append(schedule.init_state(dev))
            extra.update(opt_state_bytes=_nbytes(opt_state),
                         inputs_bytes=_nbytes(local))
            del storage, opt_state, local
            mesh.reset_stats()
            with counter:
                counter.track(args)
                step_fn(*args)
            step_kind = "train_step"
        elif shape.kind == "prefill":
            local = sharding.local_batch(batch, mesh, cfg)
            plans = sharding.compute_plans(
                storage, specs, mesh, cfg, batch=shape.global_batch,
                seq=shape.seq_len)
            step_fn = steps.make_prefill_step(cfg)
            extra.update(inputs_bytes=_nbytes(local))
            args = [storage, local]
            del storage, local
            mesh.reset_stats()
            with counter:
                counter.track(args)
                params = sharding.compute_params(args[0], plans, mesh)
                step_fn(params, args[1])
            step_kind = "prefill"
        else:  # decode
            tokens, positions, state = batch
            B = shape.global_batch
            block = sharding.local_decode_state(state, mesh, cfg, B)
            del state, batch
            rows, pos = (sharding.local_rows(t, mesh)
                         for t in (tokens, positions))
            plans = sharding.compute_plans(storage, specs, mesh, cfg,
                                           batch=B, seq=1)
            step_fn = steps.make_serve_step(cfg)
            extra.update(inputs_bytes=_nbytes(block))
            args = [storage, block, rows, pos]
            del storage, block
            mesh.reset_stats()
            with counter:
                counter.track(args)
                params = sharding.compute_params(args[0], plans, mesh)
                step_fn(params, args[1], args[2], args[3])
            step_kind = "serve_step"
    elapsed = time.perf_counter() - t0
    record = analysis.build_record(
        arch=arch, shape=shape, cfg=cfg, mesh_name=_mesh_name(mesh),
        num_chips=mesh.size(mesh.axis_names), step=step_kind,
        counter=counter, mesh=mesh, trace_seconds=elapsed, **extra)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {_mesh_name(mesh)} rank "
              f"{mesh.rank} ({step_kind}) traced in {elapsed:.1f}s")
        print(f"  per rank: params {record.params_bytes / 1e9:.4f} GB, "
              f"optimizer {record.opt_state_bytes / 1e9:.4f} GB, inputs "
              f"{record.inputs_bytes / 1e9:.4f} GB, peak "
              f"{record.peak_memory_bytes / 1e9:.4f} GB")
        print(f"  counts: flops={record.flops_per_device:.3e} "
              f"bytes={record.bytes_per_device:.3e}")
        print(f"  collectives: {record.collective_breakdown}")
        print(f"  roofline: compute={record.compute_term:.3e}s "
              f"memory={record.memory_term:.3e}s "
              f"collective={record.collective_term:.3e}s "
              f"-> {record.bottleneck}-bound "
              f"(useful-FLOPs ratio {record.useful_flops_ratio:.2f})")
    return DryrunArtifacts(
        arch=arch, shape_name=shape_name, mesh_name=_mesh_name(mesh),
        step_kind=step_kind, num_chips=record.num_chips, cfg=cfg,
        shape=shape, record=record, ops=counter.op_log(),
        trace_seconds=elapsed)


def dryrun_pair(arch: str, shape_name, *, multi_pod: bool = False,
                mesh=None, rank: int = 0, num_groups: int = 4,
                microbatches: int = 1, fsdp: bool = True,
                verbose: bool = True, rc: RobustConfig | None = None,
                schedule=None, gather_grads: bool = False,
                device: str = "cuda", return_artifacts: bool = False):
    """Trace one rank's step of (arch, shape); returns its RooflineRecord
    (``return_artifacts=True``: the ``DryrunArtifacts``)."""
    art = lower_pair(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                     rank=rank, num_groups=num_groups,
                     microbatches=microbatches, fsdp=fsdp, rc=rc,
                     schedule=schedule, gather_grads=gather_grads,
                     device=device, verbose=verbose)
    return art if return_artifacts else art.record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=list(ARCHITECTURES))
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--all", action="store_true",
                   help="run every (arch × shape) pair")
    p.add_argument("--multi-pod", action="store_true",
                   help="use the 2×16×16 multi-pod mesh")
    p.add_argument("--rank", type=int, default=0,
                   help="the rank whose program is traced")
    p.add_argument("--num-groups", type=int, default=4,
                   help="k — number of gradient batches (train shapes)")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--out", default=None, help="write JSON records here")
    args = p.parse_args(argv)

    if args.all:
        pairs = [(arch, shape) for arch in ARCHITECTURES for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    records, failures = [], []
    for arch, shape in pairs:
        try:
            records.append(dryrun_pair(
                arch, shape, multi_pod=args.multi_pod, rank=args.rank,
                num_groups=args.num_groups, microbatches=args.microbatches,
                fsdp=not args.no_fsdp))
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))

    if records:
        print()
        print(analysis.format_table(records))
    if args.out:
        analysis.save_records(records, args.out)
        print(f"\nwrote {len(records)} records to {args.out}")
    if failures:
        print(f"\nFAILURES ({len(failures)}):")
        for arch, shape, err in failures:
            print(f"  {arch} × {shape}: {err}")
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
