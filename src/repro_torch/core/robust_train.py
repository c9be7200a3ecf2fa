"""Byzantine-robust distributed training step (PyTorch port of
``repro.core.robust_train``).

The paper's Algorithm 2:

    per-worker grads (torch.func.vmap over the worker axis)
      -> simulated Byzantine corruption of reported gradients
      -> robust aggregation (GMoM by default)
      -> optimizer update

The multi-round runner is a Python loop over rounds; round ``t`` uses
``fold_in(key, t)`` as its step key, exactly as the reference's
``lax.scan`` does, so chunked runs replay step for step.  The report wire
(``cfg.compression``, ``repro_torch.core.compression``) and bounded
staleness (``cfg.arrival``/``staleness_bound``,
``repro_torch.core.staleness``) follow the reference: the merged rows are
staleness-weighted first, then encoded, then decoded or handed to a rule
whose ``native_codec`` matches.

Shard-local aggregation runs on ``torch.distributed`` ranks:
:func:`make_sharded_aggregate` is the model-axis (ZeRO-1) body, each rank
holding every worker's slice of its parameter shard, and
:func:`make_shardmap_aggregate` the data-axis GMoM, one rank a worker.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import _device
from repro_torch import random as prng
from repro_torch.core import aggregators, byzantine, compression
from repro_torch.core import shard_aggregation as sa
from repro_torch.core import staleness as staleness_lib
from repro_torch.core.geometric_median import (
    batch_mean_norms, geometric_median_pytree, median, trim_weights)
from repro_torch.core.grouping import choose_num_batches, make_grouping


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Static configuration of the robust aggregation pipeline (the same
    fields as the reference's)."""
    num_workers: int
    num_byzantine: int = 0
    num_batches: int | None = None      # None => paper's canonical choice
    aggregator: str = "gmom"
    attack: str = "none"
    attack_kwargs: tuple = ()           # tuple of (key, value) — hashable
    rotate_byzantine: bool = True
    epsilon: float = 0.1                # the paper's fixed eps in 2(1+eps)q<=k
    trim_multiplier: float | None = 3.0
    gmom_max_iters: int = 32
    gmom_tol: float = 1e-7
    grouping_scheme: str = "contiguous"
    # gmom hot path: "auto" (CUDA round kernel for CUDA tensors, reference
    # otherwise), "fused", "fused_interpret", or "reference".
    round_backend: str = "auto"
    compression: str = "none"
    arrival: str = "all_sync"
    staleness_bound: int = 0
    staleness_discount: float = 0.7
    arrival_kwargs: tuple = ()

    def resolved_num_batches(self) -> int:
        if self.num_batches is not None:
            return self.num_batches
        return choose_num_batches(self.num_workers, self.num_byzantine,
                                  epsilon=self.epsilon)


def per_worker_grads(loss_fn: Callable, params, worker_batches, *,
                     loss_kwargs: dict | None = None):
    """Stacked gradients (leaf shapes (m, *param_shape)) and per-worker
    losses: ``vmap`` over the leading worker axis of ``worker_batches``."""
    loss_kwargs = loss_kwargs or {}

    def loss(p, batch):
        return loss_fn(p, batch, **loss_kwargs)

    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss),
                                    in_dims=(None, 0))(params, worker_batches)
    return grads, losses


def aggregate_reported(reported_grads, cfg: RobustConfig, *, key,
                       shard_spec=None, staleness=None):
    """Robust aggregation of already-(possibly-)corrupted reports; which
    config fields a rule receives is driven by its registry metadata.

    ``staleness`` is an ``(age, bound, discount)`` triple from the
    bounded-staleness buffer: rows are rescaled by their normalized
    ``discount**age`` weights before the wire codec sees them.  With
    ``cfg.compression`` set, the reports are encoded (a keyed codec draws
    from ``fold_in(key, 29)``); a rule whose ``native_codec`` matches gets
    the payload with ``like=`` the reports, any other rule the decoded
    reports."""
    agg = aggregators.get_aggregator(cfg.aggregator)
    kwargs: dict[str, Any] = {}
    if staleness is not None:
        age, bound, discount = staleness
        reported_grads = staleness_lib.apply_staleness(
            reported_grads, age, bound, discount=discount)
    if cfg.compression != "none":
        codec = compression.get_codec(cfg.compression)
        ckey = None
        if codec.needs_key:
            if key is None:
                raise ValueError(
                    f"compression {cfg.compression!r} needs a PRNG key")
            ckey = prng.fold_in(key, 29)
        payload = codec.encode(reported_grads, key=ckey,
                               shard_spec=shard_spec)
        if agg.native_codec == cfg.compression:
            kwargs.update(like=reported_grads)
            reported_grads = payload
        else:
            reported_grads = codec.decode(payload, reported_grads)
    if agg.needs_num_byzantine:
        kwargs.update(num_byzantine=cfg.num_byzantine)
    if agg.needs_key:
        kwargs.update(key=prng.fold_in(key, 13))
    if agg.needs_grouping:
        kwargs.update(num_batches=cfg.resolved_num_batches(),
                      epsilon=cfg.epsilon,
                      grouping_scheme=cfg.grouping_scheme,
                      trim_multiplier=cfg.trim_multiplier,
                      max_iters=cfg.gmom_max_iters, tol=cfg.gmom_tol,
                      round_backend=cfg.round_backend)
    if agg.needs_shard_spec and shard_spec is not None:
        kwargs.update(shard_spec=shard_spec)
    return agg(reported_grads, **kwargs)


def aggregate(stacked_grads, cfg: RobustConfig, *, key, round_index,
              shard_spec=None):
    """Attack simulation + robust aggregation."""
    mask = byzantine.sample_byzantine_mask(
        key, cfg.num_workers, cfg.num_byzantine,
        rotate=cfg.rotate_byzantine, round_index=round_index)
    attack = byzantine.get_attack(cfg.attack)
    reported = attack(stacked_grads, mask, key, **dict(cfg.attack_kwargs))
    return aggregate_reported(reported, cfg, key=key, shard_spec=shard_spec)


def _grad_norm(agg_grad):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(agg_grad)))


def make_robust_train_step(loss_fn: Callable, optimizer, cfg: RobustConfig, *,
                           loss_kwargs: dict | None = None):
    """Build ``train_step(params, opt_state, worker_batches, key, round) ->
    (params, opt_state, metrics)``."""

    def train_step(params, opt_state, worker_batches, key, round_index):
        stacked, losses = per_worker_grads(loss_fn, params, worker_batches,
                                           loss_kwargs=loss_kwargs)
        agg_grad = aggregate(stacked, cfg, key=key, round_index=round_index)
        updates, opt_state = optimizer.update(agg_grad, opt_state, params)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        metrics = {"loss_mean": torch.mean(losses),
                   "loss_median": median(losses),
                   "agg_grad_norm": _grad_norm(agg_grad)}
        return params, opt_state, metrics

    return train_step


def schedule_from_config(cfg: RobustConfig) -> byzantine.AttackSchedule:
    """The AttackSchedule equivalent of the per-round ``aggregate`` path."""
    name = "rotating" if cfg.rotate_byzantine else "static"
    return byzantine.make_schedule(
        name, num_workers=cfg.num_workers, num_byzantine=cfg.num_byzantine,
        attack=cfg.attack, attack_kwargs=cfg.attack_kwargs)


def make_run_rounds(loss_fn: Callable, optimizer, cfg: RobustConfig, *,
                    schedule: byzantine.AttackSchedule | None = None,
                    loss_kwargs: dict | None = None,
                    extra_metrics: Callable | None = None,
                    arrival=None, device=None):
    """Build an N-round trainer on ``device`` (entry point: ``None`` means
    CUDA, raising when there is no card).

    Returns ``run(params, opt_state, worker_batches, key, *, num_rounds,
    start_round=0, attack_state=None, stale_buffer=None,
    per_round_batches=False) -> (params, opt_state, attack_state,
    stale_buffer, metrics)`` where ``metrics`` are stacked over rounds.
    Round ``t`` uses ``fold_in(key, t)``.  With ``cfg.aggregator == "gmom"``
    (or a rule that ends in it) and ``round_backend="auto"`` every round on
    the card goes through the CUDA round kernel.  ``extra_metrics(params,
    agg_grad)`` appends scenario metrics.

    ``arrival`` (default ``staleness.arrival_from_config(cfg)``) turns on
    the bounded-staleness path: each round the arrival model picks the
    fresh reporters (reading the attack schedule's mask for the round),
    stale workers contribute their buffered report, and the buffer is
    carried in ``stale_buffer`` with a per-round ``stale_count`` metric.
    When it resolves to None the buffer is ``()`` and the round is the
    synchronous one."""
    device = _device.enter(device)
    if arrival is None:
        arrival = staleness_lib.arrival_from_config(cfg)
    schedule = schedule if schedule is not None else schedule_from_config(cfg)
    loss_kwargs = loss_kwargs or {}

    def to_dev(tree):
        return tree_map(lambda x: x.to(device), tree)

    def run(params, opt_state, worker_batches, key, *, num_rounds=None,
            start_round=0, attack_state=None, stale_buffer=None,
            per_round_batches=False):
        if num_rounds is None:
            if not per_round_batches:
                raise ValueError("num_rounds is required with a fixed batch")
            num_rounds = tree_leaves(worker_batches)[0].shape[0]
        params, opt_state = to_dev(params), to_dev(opt_state)
        worker_batches, key = to_dev(worker_batches), key.to(device)
        astate = (schedule.init_state(device) if attack_state is None
                  else to_dev(attack_state))
        if arrival is None:
            buf = ()
        elif stale_buffer is None or len(stale_buffer) == 0:
            buf = staleness_lib.init_buffer(params, arrival.num_workers,
                                            arrival.staleness_bound)
        else:
            buf = to_dev(stale_buffer)
        start = int(start_round)
        rows = []
        for i in range(num_rounds):
            t = start + i
            batch = (tree_map(lambda x: x[i], worker_batches)
                     if per_round_batches else worker_batches)
            key_t = prng.fold_in(key, t)
            stacked, losses = per_worker_grads(loss_fn, params, batch,
                                               loss_kwargs=loss_kwargs)
            reported, mask, astate = schedule.apply(stacked, key_t, t, astate)
            del stacked   # the honest stack; at LM width it is (m, P)
            if arrival is None:
                agg_grad = aggregate_reported(reported, cfg, key=key_t)
            else:
                fresh = arrival.arrive(key_t, t, mask)
                reported, buf = staleness_lib.merge_reports(buf, reported,
                                                            fresh)
                agg_grad = aggregate_reported(
                    reported, cfg, key=key_t,
                    staleness=(buf.age, buf.bound, cfg.staleness_discount))
            updates, opt_state = optimizer.update(agg_grad, opt_state, params)
            params = tree_map(lambda p, u: (p + u).to(p.dtype),
                              params, updates)
            row = {"loss_mean": torch.mean(losses),
                   "loss_median": median(losses),
                   "agg_grad_norm": _grad_norm(agg_grad),
                   "byz_count": torch.sum(mask.to(torch.int32))}
            if arrival is not None:
                row["stale_count"] = torch.sum((buf.age > 0).to(torch.int32))
            if extra_metrics is not None:
                row.update(extra_metrics(params, agg_grad))
            rows.append(row)
        metrics = {name: torch.stack([r[name] for r in rows])
                   for name in rows[0]} if rows else {}
        return params, opt_state, astate, buf, metrics

    return run


# ---------------------------------------------------------------------------
# shard-local aggregation on torch.distributed ranks

def make_sharded_aggregate(cfg: RobustConfig, group=None, *,
                           axis: str = "model",
                           num_shards: int | None = None):
    """Shard-local aggregation body for one rank of ``group`` (default:
    WORLD), the stacked gradients partitioned over its ranks (ZeRO-1: each
    rank holds every worker's LAST-dim slice of its parameter shard).

    Every registered rule runs: coordinate-wise rules with no collective,
    norm-based rules all-gathering per-shard partial squared norms (see
    ``repro_torch.core.shard_aggregation``).  The result equals, bit for
    bit, the same slice of the ``"virtual"``-mode oracle on the whole
    gradients.  ``num_shards`` defaults to the group's size.

    Returns ``fn(stacked_local_grads, key) -> agg_grad_shard``."""
    if num_shards is None:
        num_shards = dist.get_world_size(group)
    spec = sa.ShardSpec(num_shards=num_shards, mode="shard_map", axis=axis)

    def agg_local(stacked_local, key):
        with sa.axis_group(axis, group):
            return aggregate_reported(stacked_local, cfg, key=key,
                                      shard_spec=spec)

    return agg_local


def make_shardmap_aggregate(cfg: RobustConfig, group=None):
    """GMoM with the data-axis collectives scheduled by hand: one rank of
    ``group`` (default: WORLD) per worker, ranks in worker order.

    Each rank scales its gradient into a one-hot (k, ...) contribution to
    its batch's mean; the contributions are all-gathered and summed in rank
    order (so two runs give the same bits), which leaves all k batch means
    on every rank.  The trim and Weiszfeld tail then runs on them through
    ``cfg.round_backend`` as ``gmom_aggregator`` dispatches it: the round
    kernel (or its plain version) with the identity grouping k = k, or the
    reference trim and pytree Weiszfeld.

    Needs the contiguous even grouping: raises ``ValueError`` unless k | m.
    Returns ``fn(my_grad) -> agg_grad`` (``my_grad`` has no worker axis)."""
    k = cfg.resolved_num_batches()
    m = cfg.num_workers
    if m % k != 0:
        raise ValueError(
            f"make_shardmap_aggregate requires k | m (got m={m}, k={k}); "
            "use the gmom aggregator path for uneven groupings")
    b = m // k

    def agg_local(my_grad):
        world = dist.get_world_size(group)
        if world != m:
            raise ValueError(f"make_shardmap_aggregate: {world} ranks for "
                             f"{m} workers")
        batch_id = dist.get_rank(group) // b

        def leaf(g):
            onehot = torch.zeros((k,), dtype=g.dtype, device=g.device)
            onehot[batch_id] = 1.0
            contrib = (onehot / b).reshape((k,) + (1,) * g.ndim) * g[None]
            return sa.chain_sum(sa.all_gather(contrib, group))

        means = tree_map(leaf, my_grad)
        backend = aggregators.resolve_round_backend(
            cfg.round_backend, num_batches=k,
            device=_device.device_type(tree_leaves(means)[0]))
        if backend != "reference":
            from repro_torch.kernels.geomed import round as round_kernel
            return round_kernel.round_aggregate_pytree(
                means, make_grouping(k, k),
                trim_multiplier=cfg.trim_multiplier,
                max_iters=cfg.gmom_max_iters, tol=cfg.gmom_tol,
                plain=(backend == "fused_interpret"))
        weights = None
        if cfg.trim_multiplier is not None:
            weights = trim_weights(batch_mean_norms(means),
                                   multiplier=cfg.trim_multiplier)
        return geometric_median_pytree(means, weights=weights,
                                       max_iters=cfg.gmom_max_iters,
                                       tol=cfg.gmom_tol)

    return agg_local
