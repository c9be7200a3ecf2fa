"""Multi-pod scenario sweep: attack × schedule × aggregator on the
production meshes, as a collective-cost regression gate (port of
``repro.sim.sweep``).

The linreg scenario engine (``repro_torch.sim.engine``) answers "does the
*statistics* hold up".  This module answers the systems half: the
group-mode production train step of the geometric-median-of-means path
(paper Algorithm 1/2, §5 cost model) is traced through
``repro_torch.launch.dryrun.lower_pair`` for every cell of the attack ×
schedule × aggregator matrix on the 16×16 (256-rank) and 2×16×16
(512-rank) meshes, and each cell's **collective bytes / per-kind
collective breakdown / peak memory** are recorded in the port's own
checked-in record, ``src/repro_torch/sim/pod_sweeps.json``.

The reference compiles one SPMD program and reads the partitioned HLO.
The port has no SPMD compiler: each rank runs its own program with the
collectives placed by hand, so a cell is ONE rank's program (rank 0 of
the production mesh) traced on fake tensors on that rank's abstract view
of the mesh (``Mesh.abstract``: no process group), counted by
``roofline.counter.Counter`` and ``Mesh.stats``.  The report-wire and
staleness microcells are rank programs too (``wire_program``,
``stale_program``), which the same functions run for real on a mesh of
rank processes.  The reference's ``force_host_device_count`` has no
counterpart: a fake trace needs no devices.  The record's numbers are
the port's own, held to its real runs on gloo ranks and on the card, not
to the reference's XLA numbers (``benchmarks/BENCH_pod_sweeps.json`` is
the reference's record).

A :class:`PodScenario` binds (attack, schedule, aggregator, round_backend)
to an *(arch, shape, mesh)* triple.

Usage::

    # sweep every registered scenario (both meshes) and write the record
    PYTHONPATH=src python -m repro_torch.sim.sweep --all

    # regression gate: re-trace everything and fail when any scenario's
    # collective bytes or peak memory regressed beyond tolerance vs the
    # checked-in record (or gate a payload written earlier: --fresh-from)
    PYTHONPATH=src python -m repro_torch.sim.sweep --check

    # one cell
    PYTHONPATH=src python -m repro_torch.sim.sweep \\
        --scenario pod/16x16/minitron-4b/gmom/alie/rotating

``--check`` exits 1 on: a regression beyond tolerance, a registered
scenario missing from the record, a stale record entry whose scenario is
no longer registered, or a failed shard-scaling or wire gate; 2 when
there is no record.  Improvements beyond tolerance are reported as notes
(re-record with ``--all`` to ratchet the gate down).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import _device
from repro_torch import random as prng
from repro_torch.core import (
    RobustConfig, aggregators, byzantine, compression, staleness)
from repro_torch.core import shard_aggregation as sa

# ---------------------------------------------------------------------------
# the matrix

POD_ATTACKS = ("sign_flip", "alie", "norm_stealth")
POD_SCHEDULES = ("static", "rotating", "stealth_then_strike")
POD_AGGREGATORS = ("gmom", "mean", "trimmed_mean", "krum",
                   "norm_filter_gmom")
POD_MESHES = ("16x16", "2x16x16")

#: mesh name -> multi_pod flag for launch.mesh.make_production_mesh
MESH_MULTI_POD = {"16x16": False, "2x16x16": True}

DEFAULT_ARCH = "minitron-4b"    # smallest dense production config: the
DEFAULT_SHAPE = "train_4k"      # cheapest full-size trace per cell

#: the port's checked-in record
RECORD_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "pod_sweeps.json")

RTOL_COLLECTIVE = 0.05   # collective bytes are deterministic per version
RTOL_MEMORY = 0.25       # peak memory drifts more across versions
ATOL_BYTES = 4096        # ignore sub-page jitter


@dataclasses.dataclass(frozen=True)
class PodScenario:
    """One cell of the production-mesh sweep: the adversarial degrees of
    freedom (attack, schedule, aggregator, round_backend, fault geometry)
    bound to an (arch, shape, mesh) triple.  The Byzantine granularity is
    the batch-group mean (``launch.steps`` group mode)."""
    name: str
    aggregator: str = "gmom"
    attack: str = "sign_flip"
    schedule: str = "rotating"
    mesh: str = "16x16"
    arch: str = DEFAULT_ARCH
    shape: str = DEFAULT_SHAPE
    round_backend: str = "auto"
    num_groups: int = 4          # k — batch-group count
    num_byzantine: int = 1       # q — contaminated batch means per round
    microbatches: int = 1
    # "sharded" keeps the stacked gradients on the mesh layout, shard-local
    # (O(d/shards) server memory); "gathered" gathers them whole before the
    # aggregation (the dense O(d) baseline)
    grad_mode: str = "sharded"
    # wire codec for the worker reports (core/compression.py)
    compression: str = "none"
    # True traces the report-wire microcell (lower_wire_scenario)
    wire: bool = False
    # arrival model + staleness bound (core/staleness.py); stale=True traces
    # the staleness-merge microcell (lower_stale_scenario)
    arrival: str = "all_sync"
    staleness_bound: int = 0
    stale: bool = False

    def robust_config(self) -> RobustConfig:
        """The aggregation pipeline config (num_batches == k: each
        batch-group gradient is its own batch mean)."""
        return RobustConfig(
            num_workers=self.num_groups, num_byzantine=self.num_byzantine,
            num_batches=self.num_groups, aggregator=self.aggregator,
            attack=self.attack, round_backend=self.round_backend,
            gmom_max_iters=8, compression=self.compression,
            arrival=self.arrival, staleness_bound=self.staleness_bound)

    def build_schedule(self) -> byzantine.AttackSchedule:
        return byzantine.make_schedule(
            self.schedule, num_workers=self.num_groups,
            num_byzantine=self.num_byzantine, attack=self.attack)


def capped_rc(ps: PodScenario) -> RobustConfig:
    """``ps.robust_config()`` with the Weiszfeld stop at the cap only,
    where a fake trace's stop lies (it reads no residual): the config a
    real run of the cell takes to be held to its dry run."""
    return dataclasses.replace(ps.robust_config(), gmom_tol=0.0)


_REGISTRY: dict[str, PodScenario] = {}


def register(ps: PodScenario) -> PodScenario:
    if ps.name in _REGISTRY:
        raise ValueError(f"pod scenario {ps.name!r} already registered")
    if ps.mesh not in MESH_MULTI_POD:
        raise ValueError(f"unknown mesh {ps.mesh!r}; have "
                         f"{sorted(MESH_MULTI_POD)}")
    _REGISTRY[ps.name] = ps
    return ps


def get_pod_scenario(name: str) -> PodScenario:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown pod scenario {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def _n(mesh: str, arch: str, agg: str, attack: str, schedule: str) -> str:
    return f"pod/{mesh}/{arch}/{agg}/{attack}/{schedule}"


# The full matrix, both meshes: every cell traces the real group-mode train
# step, attack and schedule included.
for _mesh in POD_MESHES:
    for _agg in POD_AGGREGATORS:
        for _attack in POD_ATTACKS:
            for _schedule in POD_SCHEDULES:
                register(PodScenario(
                    name=_n(_mesh, DEFAULT_ARCH, _agg, _attack, _schedule),
                    aggregator=_agg, attack=_attack, schedule=_schedule,
                    mesh=_mesh))


# ---------------------------------------------------------------------------
# big-model cells: the O(d/shards) server-memory claim, made a gate.
# qwen2-72b's gathered (k, d) block cannot fit one device; the sharded gmom
# cell and its gathered twin put both peaks in the record, and krum rides
# along for its (m, m) gram.

BIG_MODEL_ARCH = "qwen2-72b"

register(PodScenario(
    name=_n("16x16", BIG_MODEL_ARCH, "gmom", "sign_flip", "static"),
    aggregator="gmom", attack="sign_flip", schedule="static",
    mesh="16x16", arch=BIG_MODEL_ARCH))
register(PodScenario(
    name=_n("16x16", BIG_MODEL_ARCH, "krum", "sign_flip", "static"),
    aggregator="krum", attack="sign_flip", schedule="static",
    mesh="16x16", arch=BIG_MODEL_ARCH))
register(PodScenario(
    name=_n("16x16", BIG_MODEL_ARCH, "coord_median", "sign_flip", "static"),
    aggregator="coord_median", attack="sign_flip", schedule="static",
    mesh="16x16", arch=BIG_MODEL_ARCH))
register(PodScenario(
    name=_n("16x16", BIG_MODEL_ARCH, "gmom", "sign_flip", "static")
    + "/gathered",
    aggregator="gmom", attack="sign_flip", schedule="static",
    mesh="16x16", arch=BIG_MODEL_ARCH, grad_mode="gathered"))

#: the big-model cells (outside the full minitron matrix product)
BIG_MODEL_SCENARIOS = (
    _n("16x16", BIG_MODEL_ARCH, "gmom", "sign_flip", "static"),
    _n("16x16", BIG_MODEL_ARCH, "krum", "sign_flip", "static"),
    _n("16x16", BIG_MODEL_ARCH, "coord_median", "sign_flip", "static"),
    _n("16x16", BIG_MODEL_ARCH, "gmom", "sign_flip", "static") + "/gathered",
)


# ---------------------------------------------------------------------------
# communication-compressed cells: two full train-step cells, and three
# report-wire microcells isolating the worker -> server report traffic the
# codecs shrink (the full step is forward/backward-dominated);
# ``compression_wire_problems`` gates sign at >= 25x below the f32 baseline
# and int8 at >= 3.5x.

WIRE_REDUCTION_MIN_SIGN = 25.0
WIRE_REDUCTION_MIN_INT8 = 3.5
WIRE_RTOL = 0.05

WIRE_BASELINE_SCENARIO = \
    _n("16x16", DEFAULT_ARCH, "gmom", "sign_flip", "static") + "/wire"
WIRE_SIGN_SCENARIO = \
    _n("16x16", DEFAULT_ARCH, "sign_sgd_majority", "sign_flip", "static") \
    + "/wire"
WIRE_INT8_SCENARIO = \
    _n("16x16", DEFAULT_ARCH, "int8_gmom", "sign_flip", "static") + "/wire"

register(PodScenario(
    name=_n("16x16", DEFAULT_ARCH, "sign_sgd_majority",
            "sign_flip_targeted", "static"),
    aggregator="sign_sgd_majority", attack="sign_flip_targeted",
    schedule="static", mesh="16x16", compression="sign"))
register(PodScenario(
    name=_n("16x16", DEFAULT_ARCH, "int8_gmom", "sign_flip", "static"),
    aggregator="int8_gmom", attack="sign_flip", schedule="static",
    mesh="16x16", compression="int8_stochastic"))
register(PodScenario(
    name=WIRE_BASELINE_SCENARIO, aggregator="gmom", attack="sign_flip",
    schedule="static", mesh="16x16", compression="none", wire=True))
register(PodScenario(
    name=WIRE_SIGN_SCENARIO, aggregator="sign_sgd_majority",
    attack="sign_flip", schedule="static", mesh="16x16", compression="sign",
    wire=True))
register(PodScenario(
    name=WIRE_INT8_SCENARIO, aggregator="int8_gmom", attack="sign_flip",
    schedule="static", mesh="16x16", compression="int8_stochastic",
    wire=True))

#: the compression cells (outside the full minitron matrix product)
COMPRESSION_SCENARIOS = (
    _n("16x16", DEFAULT_ARCH, "sign_sgd_majority", "sign_flip_targeted",
       "static"),
    _n("16x16", DEFAULT_ARCH, "int8_gmom", "sign_flip", "static"),
    WIRE_BASELINE_SCENARIO,
    WIRE_SIGN_SCENARIO,
    WIRE_INT8_SCENARIO,
)


# ---------------------------------------------------------------------------
# bounded-staleness cells: two staleness-merge microcells price the
# per-round async server work at minitron-4b/16×16 (buffer merge, age
# update, discount**age weighting, gmom on the merged rows) under the
# rotating-straggler arrival with bound τ=2; one keeps the buffer cut over
# the model axis (shard-local), its /gathered twin holds it whole.

STALE_ARRIVAL = "straggler_rotating"
STALE_BOUND = 2

STALE_SHARDED_SCENARIO = \
    _n("16x16", DEFAULT_ARCH, "gmom", "sign_flip", "rotating") + "/stale"
STALE_GATHERED_SCENARIO = STALE_SHARDED_SCENARIO + "/gathered"

register(PodScenario(
    name=STALE_SHARDED_SCENARIO, aggregator="gmom", attack="sign_flip",
    schedule="rotating", mesh="16x16", arrival=STALE_ARRIVAL,
    staleness_bound=STALE_BOUND, stale=True))
register(PodScenario(
    name=STALE_GATHERED_SCENARIO, aggregator="gmom", attack="sign_flip",
    schedule="rotating", mesh="16x16", arrival=STALE_ARRIVAL,
    staleness_bound=STALE_BOUND, stale=True, grad_mode="gathered"))

#: the staleness cells (outside the full minitron matrix product)
STALE_SCENARIOS = (
    STALE_SHARDED_SCENARIO,
    STALE_GATHERED_SCENARIO,
)


# ---------------------------------------------------------------------------
# tracing one cell

def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _cfg_shape(ps: PodScenario, cfg, shape):
    """(config, InputShape) of a cell: ``cfg`` / ``shape`` (a name or an
    ``InputShape``) where given, else the scenario's own."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import InputShape
    cfg = cfg if cfg is not None else get_config(ps.arch)
    shape = shape or ps.shape
    return cfg, (shape if isinstance(shape, InputShape)
                 else get_shape(shape))


def _entry(ps: PodScenario, record, **extra) -> dict:
    from repro_torch.roofline import analysis
    entry = analysis.sweep_entry(record, scenario=ps.name)
    entry.update(
        aggregator=ps.aggregator, attack=ps.attack, schedule=ps.schedule,
        round_backend=ps.round_backend, num_groups=ps.num_groups,
        num_byzantine=ps.num_byzantine, grad_mode=ps.grad_mode,
        compression=ps.compression, **extra,
        trace_seconds=round(record.trace_seconds, 2), rank=record.rank)
    return entry


def lower_scenario(ps: PodScenario, *, mesh=None, cfg=None, shape=None,
                   device: str = "cuda", verbose: bool = False) -> dict:
    """Trace one rank's group train step of ``ps``; returns its sweep
    record entry.

    ``mesh``/``cfg``/``shape`` inject a small abstract mesh (any rank's
    view), a reduced config, and a small ``InputShape`` (the test path);
    by default rank 0 of the scenario's production mesh and its full-size
    architecture.  ``device`` is the device the rank would use."""
    from repro_torch.launch import dryrun
    art = dryrun.lower_pair(
        cfg if cfg is not None else ps.arch, shape or ps.shape,
        multi_pod=MESH_MULTI_POD[ps.mesh], mesh=mesh,
        num_groups=ps.num_groups, microbatches=ps.microbatches,
        rc=ps.robust_config(), schedule=ps.build_schedule(),
        gather_grads=(ps.grad_mode == "gathered"), device=device,
        verbose=verbose)
    return _entry(ps, art.record)


def report_width(cfg, model_n: int) -> int:
    """The flattened report's coordinate count: the config's parameter
    count padded so the model-axis split and the 8-per-word sign packing
    both stay even (relative overcount < 1e-6 at 4B params)."""
    quantum = model_n * 8
    return -(-cfg.param_count() // quantum) * quantum


def _consume(ps: PodScenario, rc: RobustConfig, reports, key, like=None):
    """The server's consume of the whole reports, with the fields
    ``robust_train.aggregate_reported`` hands the rule (its registry
    metadata), ``like`` where the rule takes the payload natively."""
    agg = aggregators.get_aggregator(ps.aggregator)
    kwargs = {}
    if like is not None:
        kwargs["like"] = like
    if agg.needs_num_byzantine:
        kwargs["num_byzantine"] = rc.num_byzantine
    if agg.needs_key:
        kwargs["key"] = prng.fold_in(key, 13)
    if agg.needs_grouping:
        kwargs.update(num_batches=rc.resolved_num_batches(),
                      epsilon=rc.epsilon,
                      grouping_scheme=rc.grouping_scheme,
                      trim_multiplier=rc.trim_multiplier,
                      max_iters=rc.gmom_max_iters, tol=rc.gmom_tol,
                      round_backend=rc.round_backend)
    return agg(reports, **kwargs)


def wire_program(ps: PodScenario, mesh, d_pad: int, rc=None):
    """One rank's REPORT WIRE of ``ps`` on ``mesh``: ``step(block, key)
    -> (aggregate, payload)``.

    ``block`` is the rank's (m, d_pad / |model|) column block of the
    flattened (m, d_pad) f32 report; it is encoded shard-local (the int8
    wire's ``q`` block is the rank's cut of the unsharded payload, its
    scales the unsharded ones: the layout path of
    ``compression._int8_encode``), the cut leaves of the payload cross
    the wire in ONE all-gather over ``model`` through the mesh, and the
    server consumes the gathered payload whole: decode and aggregate, or
    the rule's native payload path (the gmom consume reaches the round
    kernel on a CUDA tensor).  ``payload`` is the gathered payload.
    ``mesh`` None is the unsharded function on the whole report.  ``rc``
    defaults to ``ps.robust_config()``."""
    rc = ps.robust_config() if rc is None else rc
    codec = compression.get_codec(ps.compression)
    agg = aggregators.get_aggregator(ps.aggregator)
    spec = None if mesh is None else sa.layout_spec(
        [(None, "model")], tuple(mesh.shape.items()))

    def step(block, key):
        from repro_torch.models import meshctx
        ckey = prng.fold_in(key, 29) if codec.needs_key else None
        payload = codec.encode(block, key=ckey, shard_spec=spec)
        if mesh is not None:
            # the cut leaves; the int8 scales are whole on every rank
            leaves, tree = tree_flatten(payload)
            cut = [i for i, x in enumerate(leaves) if x.ndim >= 2]
            got = meshctx.all_gather_many([leaves[i] for i in cut], "model",
                                          -1, mesh=mesh)
            for i, x in zip(cut, got):
                leaves[i] = x
            payload = tree_unflatten(leaves, tree)
        like = torch.empty((block.shape[0], d_pad), dtype=torch.float32,
                           device="meta")
        if ps.compression != "none" and agg.native_codec == ps.compression:
            return _consume(ps, rc, payload, key, like=like), payload
        reports = payload
        if ps.compression != "none":
            reports = codec.decode(payload, like)
        return _consume(ps, rc, reports, key), payload

    return step


def stale_program(ps: PodScenario, mesh, d_pad: int, rc=None):
    """One rank's STALENESS MERGE of ``ps`` on ``mesh``: ``step(block,
    buf_grads, age, round_index, key) -> (aggregate, new buffer grads,
    new ages)``.

    The arrival mask (``staleness.make_arrival``) merges the fresh rows
    into the buffer (``merge_reports``), the merged rows are weighted by
    their normalized ``discount**age`` and aggregated
    (``aggregate_reported``).  ``grad_mode`` "sharded": ``block`` and the
    buffer are the rank's (m, d_pad / |model|) column blocks and the
    aggregation is shard-local over ``model`` (a ``ShardSpec`` whose
    blocked sums run in rank order); the aggregate is the rank's block.
    "gathered": the fresh block is gathered over ``model`` and the merge
    and the aggregation run whole, on a whole (m, d_pad) buffer.  Either
    way the rank computes the unsharded function (``mesh`` None), the
    sharded one up to the blocked sums' order."""
    rc = ps.robust_config() if rc is None else rc
    m = ps.num_groups
    arrival = staleness.make_arrival(
        ps.arrival, num_workers=m, staleness_bound=ps.staleness_bound)
    sharded = mesh is not None and ps.grad_mode == "sharded"
    spec = sa.ShardSpec(num_shards=mesh.size("model"), mode="shard_map",
                        axis="model") if sharded else None

    def step(block, buf_grads, age, round_index, key):
        from repro_torch.core.robust_train import aggregate_reported
        from repro_torch.models import meshctx
        if mesh is not None and not sharded:
            block = meshctx.all_gather_many([block], "model", -1,
                                            mesh=mesh)[0]
        dev = block.device
        buf = staleness.StalenessBuffer(
            grads=buf_grads, age=age.to(torch.int32),
            bound=torch.tensor(ps.staleness_bound, dtype=torch.int32,
                               device=dev))
        fresh = arrival.arrive(key, round_index,
                               torch.zeros((m,), dtype=torch.bool,
                                           device=dev))
        merged, buf = staleness.merge_reports(buf, block, fresh)
        out = aggregate_reported(
            merged, rc, key=key, shard_spec=spec,
            staleness=(buf.age, buf.bound, rc.staleness_discount))
        return out, buf.grads, buf.age

    return step


def microcell_inputs(ps: PodScenario, d: int, seed: int) -> dict:
    """A microcell's whole inputs, drawn from ``seed`` with numpy: the
    (m, d) f32 report, and for a stale cell the (m, d) buffer and the
    (m,) int32 ages (0 to the bound + 1: fresh, stale, past the bound);
    its key is ``prng.PRNGKey(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = ps.num_groups
    out = {"report": rng.standard_normal((m, d)).astype(np.float32)}
    if ps.stale:
        out["buffer"] = rng.standard_normal((m, d)).astype(np.float32)
        out["age"] = rng.integers(0, ps.staleness_bound + 2, m).astype(
            np.int32)
    return out


def run_microcell(ps: PodScenario, mesh, d: int, seed: int, *, rc=None,
                  device=None) -> dict:
    """The microcell of ``ps`` run for real on this rank of ``mesh`` (a
    mesh of rank processes, installed by the caller), or with ``mesh``
    None the unsharded function on the whole inputs, at round 0 on
    ``microcell_inputs(ps, d, seed)`` placed on ``device`` (default
    ``cuda``) -> its outputs: the aggregate (the rank's block where the
    stale buffer is cut), and the gathered payload (wire) or the new
    buffer and ages (stale)."""
    dev = _device.resolve_device(device)
    inputs = microcell_inputs(ps, d, seed)
    key = prng.PRNGKey(seed, device=dev)
    n = 1 if mesh is None else mesh.size("model")
    i = 0 if mesh is None else mesh.index("model")
    c = d // n

    def whole(x):
        return torch.from_numpy(x).to(dev)

    def cols(x):
        return torch.from_numpy(x[:, i * c:(i + 1) * c].copy()).to(dev)

    if ps.wire:
        agg, payload = wire_program(ps, mesh, d, rc=rc)(
            cols(inputs["report"]), key)
        return {"aggregate": agg, "payload": payload}
    cut = mesh is not None and ps.grad_mode == "sharded"
    buf = cols(inputs["buffer"]) if cut else whole(inputs["buffer"])
    agg, grads, age = stale_program(ps, mesh, d, rc=rc)(
        cols(inputs["report"]), buf, whole(inputs["age"]), 0, key)
    return {"aggregate": agg, "buffer": grads, "age": age}


def _trace_microcell(program, inputs, *, mesh, cfg_, shape_, arch: str,
                     step: str, device: str):
    """Trace ``program(*inputs)`` (each a (shape, dtype), or a Python value
    passed as it is) on fake tensors on ``mesh`` -> its DryrunArtifacts
    (the RooflineRecord and the counter's per-op log)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.models import meshctx
    from repro_torch.roofline import analysis
    from repro_torch.roofline.counter import Counter
    mode = FakeTensorMode()
    dev, routed = _device.trace_device(_device.traced(device))
    counter = Counter(device=dev.type)
    t0 = time.perf_counter()
    with mode, _device.route_as(routed), meshctx.set_mesh(mesh):
        args = [torch.empty(x[0], dtype=x[1], device=dev)
                if isinstance(x, tuple) else x for x in inputs]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        mesh.reset_stats()
        with counter:
            counter.track(tensors)
            program(*args)
    elapsed = time.perf_counter() - t0
    record = analysis.build_record(
        arch=arch, shape=shape_, cfg=cfg_, mesh_name=_mesh_name(mesh),
        num_chips=mesh.size(mesh.axis_names), step=step, counter=counter,
        mesh=mesh, trace_seconds=elapsed,
        inputs_bytes=float(sum(t.numel() * t.element_size()
                               for t in tensors)))
    return dryrun.DryrunArtifacts(
        arch=arch, shape_name=shape_.name, mesh_name=_mesh_name(mesh),
        step_kind=step, num_chips=record.num_chips, cfg=cfg_, shape=shape_,
        record=record, ops=counter.op_log(), trace_seconds=elapsed)


def _microcell_mesh(ps: PodScenario, mesh):
    from repro_torch.launch import mesh as mesh_lib
    if mesh is None:
        return mesh_lib.make_production_mesh(
            multi_pod=MESH_MULTI_POD[ps.mesh], rank=0)
    if not mesh.is_abstract:
        raise ValueError("a microcell traces one rank's view of a mesh "
                         "(Mesh.abstract, launch.mesh's rank=)")
    return mesh


def trace_microcell(ps: PodScenario, *, mesh=None, cfg=None, shape=None,
                    d_pad: int | None = None, device: str = "cuda"):
    """The DryrunArtifacts of one rank's microcell (a wire or a stale
    cell) traced on fake tensors: rank 0 of the production mesh unless
    ``mesh`` (an abstract view) is given; the report's width is
    ``report_width`` of the config unless ``d_pad`` (a multiple of
    |model| · 8) is given."""
    if not (ps.wire or ps.stale):
        raise ValueError(f"{ps.name} is a train-step cell, not a microcell")
    mesh = _microcell_mesh(ps, mesh)
    cfg_, shape_ = _cfg_shape(ps, cfg, shape)
    model_n = mesh.size("model")
    d_pad = report_width(cfg_, model_n) if d_pad is None else d_pad
    if d_pad % (model_n * 8):
        raise ValueError(f"d_pad {d_pad} is not a multiple of |model| · 8 "
                         f"= {model_n * 8}")
    m = ps.num_groups
    cols = d_pad // model_n
    key = ((2,), torch.int64)
    if ps.wire:
        program = wire_program(ps, mesh, d_pad)
        inputs = [((m, cols), torch.float32), key]
    else:
        program = stale_program(ps, mesh, d_pad)
        buf_cols = cols if ps.grad_mode == "sharded" else d_pad
        inputs = [((m, cols), torch.float32),
                  ((m, buf_cols), torch.float32), ((m,), torch.int32), 0,
                  key]
    return _trace_microcell(
        program, inputs, mesh=mesh, cfg_=cfg_, shape_=shape_,
        arch=ps.arch if cfg is None else cfg_.name,
        step="report_wire" if ps.wire else "stale_report", device=device)


def lower_wire_scenario(ps: PodScenario, *, mesh=None, cfg=None,
                        shape=None, device: str = "cuda",
                        verbose: bool = False) -> dict:
    """Trace one rank's REPORT WIRE of a compressed cell
    (``wire_program``) on fake tensors (``trace_microcell``); returns
    its sweep record entry.  The report is the flattened (m, d_pad)
    block: wire bytes depend only on the coordinate count.  The attack is
    upstream of the report and does not trace here (the name keeps the
    axis labels for the record's schema only)."""
    record = trace_microcell(ps, mesh=mesh, cfg=cfg, shape=shape,
                             device=device).record
    entry = _entry(ps, record)
    if verbose:
        print(f"[wire] {ps.name}: "
              f"{entry['collective_bytes_per_device']:.3e} B/dev "
              f"({record.trace_seconds:.1f}s)", flush=True)
    return entry


def lower_stale_scenario(ps: PodScenario, *, mesh=None, cfg=None,
                         shape=None, device: str = "cuda",
                         verbose: bool = False) -> dict:
    """Trace one rank's STALENESS MERGE of an async cell
    (``stale_program``) at round 0 on fake tensors
    (``trace_microcell``); returns its sweep record entry.  The report
    block and the buffer share the flattened (m, d_pad) layout of the
    wire cells; ``grad_mode`` decides whether the buffer is the rank's
    column block (O(d/shards) bytes a rank) or whole."""
    record = trace_microcell(ps, mesh=mesh, cfg=cfg, shape=shape,
                             device=device).record
    entry = _entry(ps, record, arrival=ps.arrival,
                   staleness_bound=ps.staleness_bound)
    if verbose:
        print(f"[stale] {ps.name}: "
              f"{entry['collective_bytes_per_device']:.3e} B/dev "
              f"({record.trace_seconds:.1f}s)", flush=True)
    return entry


def lower_any(ps: PodScenario, **kw) -> dict:
    """The entry of ``ps`` by its kind: wire, stale or train step."""
    if ps.wire:
        return lower_wire_scenario(ps, **kw)
    if ps.stale:
        return lower_stale_scenario(ps, **kw)
    return lower_scenario(ps, **kw)


def run_sweep(names: list[str] | None = None, *,
              verbose: bool = True) -> dict:
    """Trace every named (default: all registered) scenario; returns the
    sweep payload (the record's body)."""
    names = available() if names is None else list(names)
    scenarios: dict[str, dict] = {}
    t0 = time.time()
    for i, name in enumerate(names):
        entry = lower_any(get_pod_scenario(name))
        scenarios[name] = entry
        if verbose:
            print(f"[sweep {i + 1}/{len(names)}] {name}: "
                  f"coll={entry['collective_bytes_per_device']:.3e} B "
                  f"peak={entry['peak_memory_bytes'] or 0:.3e} B "
                  f"({entry['trace_seconds']:.1f}s)", flush=True)
    payload = {
        "matrix": {
            "attacks": list(POD_ATTACKS),
            "schedules": list(POD_SCHEDULES),
            "aggregators": list(POD_AGGREGATORS),
            "meshes": list(POD_MESHES),
        },
        "default_arch": DEFAULT_ARCH,
        "default_shape": DEFAULT_SHAPE,
        "big_model": {
            "arch": BIG_MODEL_ARCH,
            "scenarios": list(BIG_MODEL_SCENARIOS),
        },
        "compression": {
            "scenarios": list(COMPRESSION_SCENARIOS),
            "wire_reduction_min_sign": WIRE_REDUCTION_MIN_SIGN,
            "wire_reduction_min_int8": WIRE_REDUCTION_MIN_INT8,
        },
        "staleness": {
            "scenarios": list(STALE_SCENARIOS),
            "arrival": STALE_ARRIVAL,
            "staleness_bound": STALE_BOUND,
        },
        "sweep_seconds": round(time.time() - t0, 1),
        "scenarios": scenarios,
    }
    return payload


# ---------------------------------------------------------------------------
# the regression gate

def _rel_over(new: float, old: float, rtol: float, atol: float) -> bool:
    return new > old * (1.0 + rtol) + atol


def compare_payloads(record: dict, fresh: dict, *,
                     rtol_collective: float = RTOL_COLLECTIVE,
                     rtol_memory: float = RTOL_MEMORY,
                     atol: float = ATOL_BYTES) -> tuple[list[str], list[str]]:
    """Gate a fresh sweep against the checked-in record.

    Returns ``(problems, notes)``: problems fail the gate (collective-bytes
    or peak-memory regression beyond tolerance, registered scenario missing
    from the record, stale record entry); notes are informational
    (improvements beyond tolerance — re-record to ratchet — and per-kind
    ``result_bytes`` drift inside the total tolerance).
    """
    problems: list[str] = []
    notes: list[str] = []
    old_s = record.get("scenarios", {})
    new_s = fresh.get("scenarios", {})

    for name in sorted(new_s):
        if name not in old_s:
            problems.append(
                f"{name}: not in the checked-in record — re-record with "
                "`python -m repro_torch.sim.sweep --all` and commit the "
                "diff")
            continue
        old, new = old_s[name], new_s[name]
        for field, rtol, label in (
                ("collective_bytes_per_device", rtol_collective,
                 "collective bytes"),
                ("peak_memory_bytes", rtol_memory, "peak memory")):
            o, n = old.get(field), new.get(field)
            if o is None or n is None:
                continue
            if _rel_over(n, o, rtol, atol):
                problems.append(
                    f"{name}: {label} regressed {o:.4e} -> {n:.4e} "
                    f"(+{(n - o) / max(o, 1.0):.1%} > rtol {rtol:.0%})")
            elif _rel_over(o, n, rtol, atol):
                notes.append(
                    f"{name}: {label} improved {o:.4e} -> {n:.4e} — "
                    "re-record (--all) to ratchet the gate")
        ob = old.get("collective_breakdown", {})
        nb = new.get("collective_breakdown", {})
        for op in sorted(set(ob) | set(nb)):
            o, n = (float(b.get(op, {}).get("result_bytes", 0))
                    for b in (ob, nb))
            if _rel_over(n, o, rtol_collective, atol) or \
                    _rel_over(o, n, rtol_collective, atol):
                notes.append(
                    f"{name}: {op} bytes moved {o:.4e} -> {n:.4e} "
                    "(total within tolerance)")

    for name in sorted(set(old_s) - set(new_s)):
        problems.append(
            f"{name}: stale record entry (scenario no longer swept) — "
            "re-record with `python -m repro_torch.sim.sweep --all`")
    return problems, notes


#: gathered-baseline gmom peak memory must exceed the sharded cell's by at
#: least this factor on the big-model mesh: "server peak memory drops from
#: O(d) to O(d/shards)" (|model| = 16 shards; 4× leaves headroom for the
#: activations, params and optimizer state both traces share)
SHARD_MEMORY_MIN_RATIO = 4.0

#: krum's sharded peak must stay within this factor of sharded gmom's
KRUM_PEAK_MAX_RATIO = 1.5


def shard_scaling_problems(scenarios: dict) -> list[str]:
    """Gate the big-model shard-local claims on a fresh sweep payload.

    * the gathered gmom cell's peak memory must be at least
      ``SHARD_MEMORY_MIN_RATIO`` × the sharded cell's (O(d) vs O(d/shards));
    * sharded krum's peak must stay within ``KRUM_PEAK_MAX_RATIO`` × sharded
      gmom's.

    Cells absent from the payload are skipped (filtered --check runs);
    :func:`compare_payloads` keeps the cells from disappearing silently.
    """
    problems: list[str] = []

    def peak(name):
        e = scenarios.get(name)
        return e.get("peak_memory_bytes") if e else None

    base = _n("16x16", BIG_MODEL_ARCH, "gmom", "sign_flip", "static")
    g_sharded = peak(base)
    g_gathered = peak(base + "/gathered")
    k_sharded = peak(_n("16x16", BIG_MODEL_ARCH, "krum", "sign_flip",
                        "static"))

    if g_sharded and g_gathered:
        ratio = g_gathered / g_sharded
        if ratio < SHARD_MEMORY_MIN_RATIO:
            problems.append(
                f"big-model shard scaling: gathered gmom peak "
                f"{g_gathered:.3e} B is only {ratio:.2f}× the sharded "
                f"{g_sharded:.3e} B (< {SHARD_MEMORY_MIN_RATIO:.1f}×) — "
                "the O(d/shards) server-memory claim regressed")
    if g_sharded and k_sharded:
        ratio = k_sharded / g_sharded
        if ratio > KRUM_PEAK_MAX_RATIO:
            problems.append(
                f"big-model krum peak {k_sharded:.3e} B is {ratio:.2f}× "
                f"sharded gmom's {g_sharded:.3e} B "
                f"(> {KRUM_PEAK_MAX_RATIO:.1f}×) — the flattened-copy "
                "blowup is back")
    return problems


def compression_wire_problems(scenarios: dict) -> list[str]:
    """Gate the report-wire compression claims on a fresh sweep payload:
    the sign wire cell's collective bytes at least
    ``WIRE_REDUCTION_MIN_SIGN`` × below the f32 baseline wire cell's, the
    int8 cell's at least ``WIRE_REDUCTION_MIN_INT8`` ×, each with
    ``WIRE_RTOL`` slack.  Absent cells are skipped."""
    problems: list[str] = []
    base = scenarios.get(WIRE_BASELINE_SCENARIO)
    b = base.get("collective_bytes_per_device") if base else None
    if not b:
        return problems
    for name, floor, codec in (
            (WIRE_SIGN_SCENARIO, WIRE_REDUCTION_MIN_SIGN, "sign"),
            (WIRE_INT8_SCENARIO, WIRE_REDUCTION_MIN_INT8,
             "int8_stochastic")):
        e = scenarios.get(name)
        if not e:
            continue
        n = e.get("collective_bytes_per_device")
        if not n:
            problems.append(
                f"{name}: report-wire cell recorded zero collective bytes "
                "— the wire all-gather was optimized away; the cell no "
                "longer measures the report path")
            continue
        ratio = b / n
        if ratio < floor * (1.0 - WIRE_RTOL):
            problems.append(
                f"compression wire: {codec} report moves {n:.3e} B/device "
                f"vs the f32 baseline's {b:.3e} — only {ratio:.1f}× "
                f"reduction (< {floor:.1f}× floor) — the wire-cost claim "
                "regressed")
    return problems


def load_record(path: str = RECORD_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def _save_bench(payload: dict, path: str = RECORD_PATH) -> str:
    """Write the sweep record, stamped with the torch version, the device
    the traces' fake tensors lay on and the device type they routed as
    (``_device.trace_device`` of "cuda": the CPU routed as CUDA where this
    build has no CUDA), and the host's CPU count (collective bytes compare
    within a version)."""
    dev, routed = _device.trace_device("cuda")
    record = {
        "bench": "pod_sweeps",
        "recorded_unix": int(time.time()),
        "torch_version": torch.__version__,
        "device": str(dev),
        "route_as": routed,
        "cpu_count": os.cpu_count(),
        **payload,
    }
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return path


def _format_entries(scenarios: dict[str, dict]) -> str:
    rows = ["| scenario | mesh | collective B/dev | peak B/rank | "
            "bottleneck |", "|---|---|---|---|---|"]
    for name in sorted(scenarios):
        e = scenarios[name]
        peak = (f"{e['peak_memory_bytes']:.3e}"
                if e.get("peak_memory_bytes") else "n/a")
        rows.append(
            f"| {name} | {e['mesh']} "
            f"| {e['collective_bytes_per_device']:.3e} | {peak} "
            f"| {e['bottleneck']} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--all", action="store_true",
                   help="sweep every registered scenario and write the "
                        "checked-in record src/repro_torch/sim/"
                        "pod_sweeps.json")
    p.add_argument("--scenario", action="append", default=[],
                   help="sweep one named scenario (repeatable)")
    p.add_argument("--multi-pod", action="store_true",
                   help="restrict to the 2x16x16 mesh half of the matrix")
    p.add_argument("--single-pod", action="store_true",
                   help="restrict to the 16x16 mesh half of the matrix")
    p.add_argument("--check", action="store_true",
                   help="re-sweep and fail on regressions vs the checked-in "
                        "record")
    p.add_argument("--record-path", default=RECORD_PATH,
                   help="checked-in record to gate against / write")
    p.add_argument("--fresh-from", default=None,
                   help="with --check: read the fresh sweep payload from "
                        "this JSON instead of tracing")
    p.add_argument("--out", default=None,
                   help="write the fresh sweep payload (scratch JSON)")
    p.add_argument("--rtol-collective", type=float, default=RTOL_COLLECTIVE)
    p.add_argument("--rtol-memory", type=float, default=RTOL_MEMORY)
    args = p.parse_args(argv)

    names = available()
    if args.multi_pod:
        names = [n for n in names if get_pod_scenario(n).mesh == "2x16x16"]
    if args.single_pod:
        names = [n for n in names if get_pod_scenario(n).mesh == "16x16"]
    if args.scenario:
        for n in args.scenario:
            get_pod_scenario(n)   # fail fast on typos
        names = args.scenario
    elif not (args.all or args.check):
        p.error("pass --all, --check, or --scenario NAME")
    filtered = bool(args.multi_pod or args.single_pod or args.scenario)

    if args.fresh_from:
        with open(args.fresh_from) as f:
            fresh = json.load(f)
    else:
        fresh = run_sweep(names)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(fresh, f, indent=1)
        print(f"wrote fresh sweep payload to {args.out}")

    if args.check:
        if not os.path.exists(args.record_path):
            print(f"sweep --check: no record at {args.record_path} — "
                  "record one with `python -m repro_torch.sim.sweep --all`")
            return 2
        record = load_record(args.record_path)
        if filtered:
            # a filtered gate run compares the swept subset only: record
            # entries outside the filter are out of scope, not stale
            swept = set(names)
            record = dict(record)
            record["scenarios"] = {
                n: e for n, e in record.get("scenarios", {}).items()
                if n in swept}
        problems, notes = compare_payloads(
            record, fresh,
            rtol_collective=args.rtol_collective,
            rtol_memory=args.rtol_memory)
        problems += shard_scaling_problems(fresh.get("scenarios", {}))
        problems += compression_wire_problems(fresh.get("scenarios", {}))
        for n in notes:
            print(f"sweep note: {n}")
        for pr in problems:
            print(f"sweep REGRESSION: {pr}")
        if problems:
            print(f"sweep --check: FAILED ({len(problems)} problem(s))")
            return 1
        print(f"sweep --check: ok — {len(fresh.get('scenarios', {}))} "
              "scenario(s) within tolerance of the checked-in record")
        return 0

    print()
    print(_format_entries(fresh["scenarios"]))
    if args.all:
        path = _save_bench(fresh, args.record_path)
        print(f"\nwrote record {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
