"""Layer B: every registered aggregator's *declared* shard contract held
against the collectives its shard-local body makes (port of
``repro.verify.contracts``).

For each aggregator the analyzer runs the production path, the
``make_sharded_aggregate`` body of rank 0 of an abstract ("model",) mesh
of ``num_shards`` ranks, on fake tensors, and checks the declaration
against the mesh's log of its collectives (``repro_torch.verify.
collectives``):

* ``coordinate_wise``: ZERO collectives.  RV201 on violation.
* ``norm_based``: collectives allowed, but *d-independent*: at hidden
  size d and 2d the collective shapes are the same (the (k,)/(m,)/(m,m)
  partial reductions of PAPER.md Thm 3, never O(d) traffic), and no
  collective moves more than ``num_shards * m * m`` elements.  RV202.
* ``whole_gradient`` (krum): the collectives must still be d-independent.
  RV202.

The fake run's loops stop where the ``"virtual"`` oracle's real run on
the whole harness tree stopped (``_device.host_tape``): the oracle gives
the shard-local result bit for bit, so a real rank reads the same values
and makes the same collectives.  Given real ranks' logs (the CLI's
``--full-matrix``, and the card's check; :func:`real_rank` is their body)
each must equal the traced one in kind, shape and bytes (RV201/RV202 by
contract).

Independently, a **determinism audit** (RV203) runs the gathered
``"virtual"``-mode oracle with a uniquely sized shard axis (S = 5, which
no worker, group or leaf extent of the harness has) and flags any aten
``sum``/``mean``/``prod`` over an extent-5 dim: such a reduction hands
the kernel back the choice of order that the unrolled ``chain_sum`` of
``core/shard_aggregation.py`` removes.

Layer C certifies graphs (:func:`trace`: ``make_fx`` of the
functionalized path on fake tensors), whose loops run to their caps (the
static bound, as the reference's while loop).  The flat path is traced
with ``round_backend="reference"``: the round kernel's op is opaque to a
graph walk, and the reference path is the semantics the kernel is held
to.

No literal seeds here: harness arrays are deterministic sin fills and the
traced key is built from a caller-supplied seed (this module is linted by
its own Layer A, RV102).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch import _device
from repro_torch import random as prng
from repro_torch.core import aggregators
from repro_torch.core import shard_aggregation as sa
from repro_torch.core.robust_train import (RobustConfig, aggregate_reported,
                                           make_sharded_aggregate)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import meshctx
from repro_torch.verify import collectives
from repro_torch.verify.rules import Finding

# harness geometry: m workers, k groups, one Byzantine; leaf last dims are
# multiples of 8 so every supported shard count (2/4/8) divides them.
HARNESS_M = 8
HARNESS_K = 4
HARNESS_Q = 1

# determinism-audit geometry: shard count 5 is NO other extent (workers
# 12, groups 6, trim slice 4, leaf dims 15/3/10 and their per-shard
# slices 3/2), so an extent-5 reduction can only be over the shard stack.
DET_SHARDS = 5
DET_M = 12
DET_K = 6
_DET_OPS = ("sum", "mean", "prod")

AXIS = "model"


def _fill(shape, salt: int):
    n = int(np.prod(shape)) if shape else 1
    base = np.arange(n, dtype=np.float64) * 0.37 + float(salt) * 1.61
    return torch.as_tensor(np.sin(base).reshape(shape), dtype=torch.float32)


def harness_tree(m: int, scale: int):
    """Stacked-gradient tree; ``scale`` multiplies the sharded last dims
    (the d-independence probe)."""
    return {
        "w": _fill((m, 16 * scale), 3),
        "b": {"x": _fill((m, 4, 8 * scale), 5)},
        "s": _fill((m,), 7),
    }


def harness_cfg(name: str, *, m: int = HARNESS_M, k: int = HARNESS_K,
                q: int = HARNESS_Q, codec: str | None = None,
                round_backend: str = "auto"):
    """The harness config.  An aggregator with a native wire codec is
    traced through its compressed production path (encode, payload,
    native consume): sign_sgd_majority's zero-collective promise must hold
    for the packing and the vote, int8_gmom's d-independence must cover
    the per-worker scale combine.  Layer C's full matrix overrides
    ``codec`` to probe every wire format."""
    return RobustConfig(num_workers=m, num_byzantine=q, num_batches=k,
                        attack="none", aggregator=name,
                        gmom_max_iters=8, gmom_tol=1e-7,
                        compression=_resolve_codec(name, codec),
                        round_backend=round_backend)


def local_tree(stacked, index: int, num_shards: int):
    """Shard ``index``'s part of the stacked tree: the last-dim slice of
    every leaf with param dims, a (m,) leaf whole."""
    return tree_map(lambda x: x if x.ndim == 1
                    else sa.shard_slice(x, index, num_shards), stacked)


def _anchor(name: str) -> str:
    return f"<aggregator:{name}>"


def _resolve_codec(name: str, codec: str | None) -> str:
    if codec is not None:
        return codec
    return aggregators.get_aggregator(name).native_codec or "none"


def trace(fn, args):
    """``make_fx`` of the functionalized ``fn`` on fake copies of
    ``args``: a graph of aten (and custom) ops with no mutation or
    aliasing, its loops run to their caps."""
    return make_fx(torch.func.functionalize(fn, remove="mutations_and_views"),
                   tracing_mode="fake")(*args)


class _Reductions(TorchDispatchMode):
    """Records the (op name, input shape, reduced dims) of every aten
    sum/mean/prod run under it in ``seen``."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _DET_OPS:
            shape = tuple(args[0].shape)
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            self.seen.append((name, shape, _dims(dims, len(shape))))
        return func(*args, **kwargs)


def fake_run(fn, args, *, tape=None, modes=()):
    """``fn`` on fake copies of ``args`` (no graph), its loops replaying
    ``tape``, under the dispatch ``modes`` -> its output."""
    mode = FakeTensorMode()
    fake = tree_map(mode.from_tensor, args)
    with contextlib.ExitStack() as stack:
        stack.enter_context(_device.host_tape(tape))
        stack.enter_context(mode)
        for m in modes:
            stack.enter_context(m)
        return fn(*fake)


def record_tape(fn, args) -> list:
    """The host reads (``_device.host_value``) of ``fn(*args)`` run for
    real: where a loop stopped on these inputs."""
    with _device.host_tape() as tape:
        fn(*args)
    return tape


# --------------------------------------------------------------------------
# cache
#
# One run serves every rule that reads it: RV201/RV202 the shard-local
# logs, RV203 the virtual oracle's reductions, and Layer C re-walks the
# traced graphs with influence labels.  Each (kind, aggregator, codec,
# shards, scale, seed) cell runs once a process.

_TRACE_CACHE: dict[tuple, object] = {}


def clear_trace_cache() -> None:
    """Drop every cached run (tests re-registering dummy aggregators)."""
    _TRACE_CACHE.clear()


def _virtual_fn(cfg, num_shards: int):
    spec = sa.ShardSpec(num_shards=num_shards, mode="virtual", axis=AXIS)
    return lambda s, k: aggregate_reported(s, cfg, key=k, shard_spec=spec)


def _shard_map_cell(name, num_shards, scale, seed, codec):
    """(rank 0's body on its abstract mesh, the mesh, the body's args, the
    whole harness tree, the key)."""
    cfg = harness_cfg(name, codec=codec)
    whole = harness_tree(HARNESS_M, scale)
    key = prng.PRNGKey(seed)
    mesh = mesh_lib.make_mesh((num_shards,), (AXIS,), rank=0)
    agg = make_sharded_aggregate(cfg, axis=AXIS, num_shards=num_shards)

    def fn(stacked, k):
        with meshctx.set_mesh(mesh):
            return agg(stacked, k)

    return fn, mesh, (local_tree(whole, 0, num_shards), key), cfg, whole


def virtual_tape(name: str, *, num_shards: int, scale: int = 1,
                 seed: int = 0, device="cpu") -> list:
    """The host reads of the ``"virtual"`` oracle's real run of the
    harness cell on ``device`` (where the card's ranks will stop)."""
    whole = tree_map(lambda x: x.to(device), harness_tree(HARNESS_M, scale))
    return record_tape(_virtual_fn(harness_cfg(name), num_shards),
                       (whole, prng.PRNGKey(seed, device=device)))


def shard_map_log(name: str, *, num_shards: int, scale: int, seed: int,
                  codec: str | None = None, tape=None) -> list:
    """The collective log of rank 0's shard-local body on the abstract
    mesh, a fake run whose loops stop where the virtual oracle's run on
    the CPU stopped, or as ``tape`` says (``virtual_tape`` on the card).
    An oracle that fails to run leaves the loops at their caps (RV203
    reports it)."""
    codec = _resolve_codec(name, codec)
    key = ("log", name, codec, num_shards, scale, seed,
           None if tape is None else tuple(tape))
    if key not in _TRACE_CACHE:
        fn, mesh, args, cfg, whole = _shard_map_cell(name, num_shards, scale,
                                                     seed, codec)
        if tape is None:
            try:
                tape = record_tape(_virtual_fn(cfg, num_shards),
                                   (whole, args[1]))
            except Exception:  # noqa: BLE001  (RV203 reports the oracle)
                tape = None
        with mesh.log_calls() as log:
            fake_run(fn, args, tape=tape)
        _TRACE_CACHE[key] = list(log)
    return _TRACE_CACHE[key]


def traced_shard_map(name: str, *, num_shards: int, scale: int, seed: int,
                     codec: str | None = None):
    """(graph, output tree, collective log, example args) of rank 0's
    shard-local body on the abstract mesh, its loops run to their caps
    (the graph Layer C certifies)."""
    codec = _resolve_codec(name, codec)
    key = ("shard_map", name, codec, num_shards, scale, seed)
    if key not in _TRACE_CACHE:
        fn, mesh, args, _cfg, _whole = _shard_map_cell(name, num_shards,
                                                       scale, seed, codec)
        holder = {}

        def keep(stacked, k):
            holder["out"] = fn(stacked, k)
            return holder["out"]

        with mesh.log_calls() as log:
            gm = trace(keep, args)
        if collectives.graph_transfers(gm) != len(log):
            raise RuntimeError(
                f"{name}: the traced graph holds "
                f"{collectives.graph_transfers(gm)} collectives, the mesh's "
                f"log {len(log)}")
        _TRACE_CACHE[key] = (gm, holder["out"], list(log), args)
    return _TRACE_CACHE[key]


def traced_flat(name: str, *, seed: int, codec: str | None = None,
                route: str | None = None):
    """(graph, output tree, example args) of the unsharded
    ``aggregate_reported`` path on the harness tree, its loops run to
    their caps.  ``route=None`` pins ``round_backend`` to the reference
    pipeline (the certificate's route); ``route="cuda"`` traces the
    production route, ``auto`` with the fake tensors routed as the
    card's (``_device.route_as``), which reaches the round kernel's op
    (whose loop stops on the device)."""
    codec = _resolve_codec(name, codec)
    key = ("flat", name, codec, route, 1, seed)
    if key not in _TRACE_CACHE:
        cfg = harness_cfg(name, codec=codec,
                          round_backend="reference" if route is None
                          else "auto")
        args = (harness_tree(HARNESS_M, 1), prng.PRNGKey(seed))
        holder = {}

        def fn(stacked, k):
            with _device.route_as(route):
                holder["out"] = aggregate_reported(stacked, cfg, key=k)
            return holder["out"]

        gm = trace(fn, args)
        _TRACE_CACHE[key] = (gm, holder["out"], args)
    return _TRACE_CACHE[key]


def check_aggregator(name: str, *, num_shards: int = 4, seed: int = 0,
                     real_calls=None) -> list[Finding]:
    """All Layer-B findings for one registered aggregator.  ``real_calls``
    (one log a real rank, from :func:`real_collectives`) adds the
    real-against-traced comparison."""
    contract = aggregators.get_aggregator(name).shard_contract
    findings: list[Finding] = []
    anchor = _anchor(name)
    calls = {scale: shard_map_log(name, num_shards=num_shards, scale=scale,
                                  seed=seed) for scale in (1, 2)}

    if contract == "coordinate_wise":
        if calls[1]:
            findings.append(Finding(
                rule="RV201", path=anchor, line=0, col=0,
                message=f"declared coordinate_wise but the shard-local "
                        f"body makes cross-shard collectives: "
                        f"{collectives.fmt(calls[1])}"))
    else:
        if collectives.key(calls[1]) != collectives.key(calls[2]):
            findings.append(Finding(
                rule="RV202", path=anchor, line=0, col=0,
                message=f"collective shapes change with hidden size d "
                        f"(d-dependent traffic): d -> "
                        f"{collectives.fmt(calls[1])} vs 2d -> "
                        f"{collectives.fmt(calls[2])}"))
        if contract == "norm_based":
            cap = num_shards * HARNESS_M * HARNESS_M
            for c in calls[1]:
                if c.elements > cap:
                    findings.append(Finding(
                        rule="RV202", path=anchor, line=0, col=0,
                        message=f"norm_based collective {c.kind}"
                                f"{list(c.shape)} moves {c.elements} "
                                f"elements > cap {cap} (num_shards*m*m): "
                                f"partial reductions must stay "
                                f"(k,)/(m,)/(m,m)-shaped"))

    if real_calls is not None:
        rule = "RV201" if contract == "coordinate_wise" else "RV202"
        for rank, real in enumerate(real_calls):
            problem = collectives.diff(calls[1], real)
            if problem is not None:
                findings.append(Finding(
                    rule=rule, path=anchor, line=0, col=0,
                    message=f"rank {rank}'s real collectives differ from "
                            f"the traced ones: {problem}"))

    findings.extend(audit_determinism(name, seed=seed))
    return findings


# --------------------------------------------------------------------------
# the real view: the same body on real ranks

def real_rank(rank: int, world: int, names, seed: int, device: str = "cpu"):
    """Rank body (``launch.ranks.run``): {aggregator: this rank's collective
    log as tuples} of the shard-local harness body on a real ("model",)
    mesh of ``world`` ranks (the caller's default group)."""
    mesh = mesh_lib.make_mesh((world,), (AXIS,))
    stacked = tree_map(lambda x: x.to(device),
                       local_tree(harness_tree(HARNESS_M, 1), rank, world))
    key = prng.PRNGKey(seed, device=device)
    out = {}
    for name in names:
        agg = make_sharded_aggregate(harness_cfg(name), axis=AXIS,
                                     num_shards=world)
        with meshctx.set_mesh(mesh), mesh.log_calls() as log:
            agg(stacked, key)
        out[name] = collectives.as_tuples(log)
    return out


def real_collectives(names, *, num_shards: int, seed: int = 0,
                     timeout: float = 600.0) -> dict:
    """{aggregator: [each rank's log]} from ``num_shards`` gloo ranks on
    this host (one spawn for every name)."""
    from repro_torch.launch import ranks
    per_rank = ranks.run(real_rank, num_shards, list(names), seed,
                         timeout=timeout)
    return {name: [collectives.from_tuples(r[name]) for r in per_rank]
            for name in names}


# --------------------------------------------------------------------------
# determinism audit (RV203)

def _dims(dims, ndim: int) -> list[int]:
    """The dims a sum/mean/prod reduces (all, with no dim argument)."""
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(ndim))
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return [d % max(ndim, 1) for d in dims if isinstance(d, int)]


def audit_determinism(name: str, *, seed: int = 0) -> list[Finding]:
    """Run the gathered virtual-mode oracle with the uniquely sized shard
    axis on fake tensors and flag order-free reductions over it."""
    cache_key = ("virtual", name, None, DET_SHARDS, 1, seed)
    try:
        if cache_key not in _TRACE_CACHE:
            fn = _virtual_fn(harness_cfg(name, m=DET_M, k=DET_K), DET_SHARDS)
            args = ({"w": _fill((DET_M, 15), 11),
                     "b": {"x": _fill((DET_M, 3, 10), 13)},
                     "s": _fill((DET_M,), 17)}, prng.PRNGKey(seed))
            rec = _Reductions()
            fake_run(fn, args, tape=record_tape(fn, args), modes=(rec,))
            _TRACE_CACHE[cache_key] = rec.seen
        seen = _TRACE_CACHE[cache_key]
    except Exception as e:  # noqa: BLE001
        # an aggregator that cannot run under the meshless virtual spec
        # (a hardcoded collective) also breaks the sharded-vs-gathered bit
        # equality oracle: a contract violation, not a checker failure
        return [Finding(
            rule="RV203", path=_anchor(name), line=0, col=0,
            message=f"gathered virtual-mode oracle failed to run "
                    f"({type(e).__name__}: {e}): every aggregator must "
                    f"route cross-shard work through the ShardSpec so the "
                    f"single-process oracle stays traceable")]

    findings: list[Finding] = []
    for op, shape, dims in seen:
        bad = [d for d in dims if shape[d] == DET_SHARDS]
        if bad:
            findings.append(Finding(
                rule="RV203", path=_anchor(name), line=0, col=0,
                message=f"aten {op} over dim {bad} of shape {shape} "
                        f"reduces the {DET_SHARDS}-extent shard stack: use "
                        f"the unrolled chain_sum of "
                        f"core/shard_aggregation.py (bit-stability)"))
    return findings
