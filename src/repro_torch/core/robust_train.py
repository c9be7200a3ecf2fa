"""Byzantine-robust distributed training step (PyTorch port of
``repro.core.robust_train``).

The paper's Algorithm 2:

    per-worker grads (torch.func.vmap over the worker axis)
      -> simulated Byzantine corruption of reported gradients
      -> robust aggregation (GMoM by default)
      -> optimizer update

The multi-round runner is a Python loop over rounds; round ``t`` uses
``fold_in(key, t)`` as its step key, exactly as the reference's
``lax.scan`` does, so chunked runs replay step for step.  Wire compression
(ROADMAP Queue 1 item 11) and asynchronous arrival (item 12) are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import _device
from repro_torch import random as prng
from repro_torch.core import aggregators, byzantine
from repro_torch.core.geometric_median import median
from repro_torch.core.grouping import choose_num_batches


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


def _check_ported(cfg: RobustConfig):
    if cfg.compression != "none":
        raise NotImplementedError(
            f"compression={cfg.compression!r}: wire codecs are ROADMAP "
            "Queue 1 item 11")
    if cfg.arrival != "all_sync" or cfg.staleness_bound != 0:
        raise NotImplementedError(
            f"arrival={cfg.arrival!r}, staleness_bound="
            f"{cfg.staleness_bound}: asynchronous arrival is ROADMAP Queue 1 "
            "item 12")


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
    config fields a rule receives is driven by its registry metadata."""
    _check_ported(cfg)
    if staleness is not None:
        raise NotImplementedError("staleness weighting is ROADMAP Queue 1 "
                                  "item 12")
    agg = aggregators.get_aggregator(cfg.aggregator)
    kwargs: dict[str, Any] = {}
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


def aggregate(stacked_grads, cfg: RobustConfig, *, key, round_index):
    """Attack simulation + robust aggregation."""
    mask = byzantine.sample_byzantine_mask(
        key, cfg.num_workers, cfg.num_byzantine,
        rotate=cfg.rotate_byzantine, round_index=round_index)
    attack = byzantine.get_attack(cfg.attack)
    reported = attack(stacked_grads, mask, key, **dict(cfg.attack_kwargs))
    return aggregate_reported(reported, cfg, key=key)


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
    and ``round_backend="auto"`` every round on the card goes through the
    CUDA round kernel.  ``extra_metrics(params, agg_grad)`` appends
    scenario metrics."""
    device = _device.enter(device)
    _check_ported(cfg)
    if arrival is not None:
        raise NotImplementedError("asynchronous arrival is ROADMAP Queue 1 "
                                  "item 12")
    schedule = schedule if schedule is not None else schedule_from_config(cfg)
    loss_kwargs = loss_kwargs or {}

    def to_dev(tree):
        return tree_map(lambda x: x.to(device), tree)

    def run(params, opt_state, worker_batches, key, *, num_rounds=None,
            start_round=0, attack_state=None, stale_buffer=None,
            per_round_batches=False):
        if stale_buffer not in (None, ()):
            raise NotImplementedError("a staleness buffer is ROADMAP Queue 1 "
                                      "item 12")
        if num_rounds is None:
            if not per_round_batches:
                raise ValueError("num_rounds is required with a fixed batch")
            num_rounds = tree_leaves(worker_batches)[0].shape[0]
        params, opt_state = to_dev(params), to_dev(opt_state)
        worker_batches, key = to_dev(worker_batches), key.to(device)
        astate = (schedule.init_state(device) if attack_state is None
                  else to_dev(attack_state))
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
            agg_grad = aggregate_reported(reported, cfg, key=key_t)
            updates, opt_state = optimizer.update(agg_grad, opt_state, params)
            params = tree_map(lambda p, u: (p + u).to(p.dtype),
                              params, updates)
            row = {"loss_mean": torch.mean(losses),
                   "loss_median": median(losses),
                   "agg_grad_norm": _grad_norm(agg_grad),
                   "byz_count": torch.sum(mask.to(torch.int32))}
            if extra_metrics is not None:
                row.update(extra_metrics(params, agg_grad))
            rows.append(row)
        metrics = {name: torch.stack([r[name] for r in rows])
                   for name in rows[0]} if rows else {}
        return params, opt_state, astate, (), metrics

    return run
