"""Bounded-staleness gradient buffering (PyTorch port of
``repro.core.staleness``).

The paper's system model (§2) is synchronous: the server waits for all m
reports each round.  This module relaxes it with a bounded-staleness
buffer, as production parameter servers do:

* ``StalenessBuffer`` keeps each worker's last reported gradient and its
  age (rounds since it was fresh).  A round aggregates the fresh reports
  merged with buffered ones whose age is at most the bound τ.
* Rows are weighted by ``discount ** age`` and renormalized so the live
  weights sum to m; rows older than τ get weight zero (the hard drop).
* An ``ArrivalSchedule`` decides which workers deliver fresh reports each
  round: honest straggler models and the adversarial
  ``byzantine_max_stale``, where the Byzantine workers stay fresh while
  every honest worker is delayed to the bound.

The buffer rides the runner's carry, so it lives in ``TrainState``
(field ``stale_buffer``; ``()`` when the path is disabled) with tensor
leaves only and int32 ages.  ``all_sync`` with τ = 0 keeps the buffer
empty and is the synchronous trainer, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import random as prng


class StalenessBuffer(NamedTuple):
    """Per-worker last-reported gradients, their ages and the bound τ.

    ``grads`` mirrors the stacked-gradient pytree (leaves (m, *shape));
    ``age`` is (m,) int32, 0 meaning "reported this round"; ``bound`` is a
    0-d int32 tensor, so the whole buffer is a tensor pytree."""
    grads: Any
    age: torch.Tensor
    bound: torch.Tensor


def init_buffer(params, num_workers: int, bound: int) -> StalenessBuffer:
    """Round-zero buffer on the params' device: zero gradients aged past
    the bound, so nothing uninitialized can enter an aggregate."""
    device = tree_leaves(params)[0].device
    grads = tree_map(
        lambda p: torch.zeros((num_workers,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device), params)
    return StalenessBuffer(
        grads=grads,
        age=torch.full((num_workers,), bound + 1, dtype=torch.int32,
                       device=device),
        bound=torch.tensor(bound, dtype=torch.int32, device=device))


def merge_reports(buf: StalenessBuffer, reported, fresh):
    """One round's buffer update: fresh rows replace their buffered entry
    (age resets to 0), stale rows keep the buffered gradient and age by
    one.  Returns ``(merged_rows, new_buffer)``; the merged rows are the
    unweighted union (fresh rows pass through bit for bit) and are what
    the new buffer stores."""
    fresh = fresh.to(torch.bool)

    def leaf(rep, old):
        sel = fresh.reshape((fresh.shape[0],) + (1,) * (rep.ndim - 1))
        return torch.where(sel, rep, old)

    merged = tree_map(leaf, reported, buf.grads)
    age = torch.where(fresh, torch.zeros_like(buf.age), buf.age + 1)
    return merged, StalenessBuffer(grads=merged, age=age.to(torch.int32),
                                   bound=buf.bound)


def staleness_weights(age, bound, *, discount: float):
    """Per-row weight: ``discount ** age`` while age <= bound, exactly 0.0
    beyond it.  Fresh rows get exactly 1.0, not a computed power, so the
    all-fresh round is the synchronous one bit for bit."""
    one = torch.ones((), dtype=torch.float32, device=age.device)
    base = torch.tensor(discount, dtype=torch.float32, device=age.device)
    w = torch.where(age == 0, one, torch.pow(base, age.to(torch.float32)))
    return torch.where(age <= bound, w, torch.zeros_like(w))


def apply_staleness(rows, age, bound, *, discount: float):
    """Scale the merged rows by their normalized staleness weights: row j
    by ``m * w_j / sum(w)`` in float32, cast back.  Dropped rows scale to
    exactly zero; with every row fresh the scale is exactly 1.0."""
    m = age.shape[0]
    w = staleness_weights(age, bound, discount=discount)
    total = torch.clamp(torch.sum(w), min=1e-12)
    scale = (m * w) / total

    def leaf(g):
        s = scale.reshape((m,) + (1,) * (g.ndim - 1))
        return (g.to(torch.float32) * s).to(g.dtype)

    return tree_map(leaf, rows)


# ---------------------------------------------------------------------------
# arrival schedules: who delivers a fresh report this round

@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """Which workers report fresh each round.

    ``arrive(key, round_index, byz_mask) -> (m,) bool`` on the key's
    device, stateless: it reads only the round's key, the round index (an
    int or a 0-d integer tensor) and the attack schedule's Byzantine mask
    for the round, so adversarial arrival can collude with the attack."""
    name: str
    num_workers: int
    staleness_bound: int
    arrive: Callable[..., torch.Tensor]


_ARRIVAL_REGISTRY: dict[str, Callable[..., ArrivalSchedule]] = {}
_ARRIVAL_DESCRIPTIONS: dict[str, str] = {}


def register_arrival(name: str, description: str = ""):
    def deco(make):
        _ARRIVAL_REGISTRY[name] = make
        _ARRIVAL_DESCRIPTIONS[name] = description
        return make
    return deco


def make_arrival(name: str, *, num_workers: int, staleness_bound: int,
                 **kwargs) -> ArrivalSchedule:
    if name not in _ARRIVAL_REGISTRY:
        raise KeyError(
            f"unknown arrival schedule {name!r}; have "
            f"{sorted(_ARRIVAL_REGISTRY)}")
    return _ARRIVAL_REGISTRY[name](
        num_workers=num_workers, staleness_bound=staleness_bound, **kwargs)


def available_arrivals() -> list[str]:
    return sorted(_ARRIVAL_REGISTRY)


def describe() -> list[tuple[str, str]]:
    """(name, description) rows for every registered arrival schedule."""
    return [(n, _ARRIVAL_DESCRIPTIONS[n]) for n in available_arrivals()]


def arrival_from_config(cfg) -> ArrivalSchedule | None:
    """The configured arrival model, or None when the asynchronous path is
    off (``all_sync`` with τ = 0, the synchronous default)."""
    if cfg.arrival == "all_sync" and cfg.staleness_bound == 0:
        return None
    return make_arrival(cfg.arrival, num_workers=cfg.num_workers,
                        staleness_bound=cfg.staleness_bound,
                        **dict(cfg.arrival_kwargs))


def _workers(num_workers: int, key):
    return torch.arange(num_workers, device=key.device)


@register_arrival("all_sync",
                  "every worker reports fresh every round (the paper's §2 "
                  "synchronous model; with τ=0 this IS the sync trainer)")
def all_sync(*, num_workers, staleness_bound, **_kw) -> ArrivalSchedule:
    def arrive(key, round_index, byz_mask):
        del round_index, byz_mask
        return torch.ones((num_workers,), dtype=torch.bool, device=key.device)

    return ArrivalSchedule("all_sync", num_workers, staleness_bound, arrive)


@register_arrival("straggler_fixed",
                  "a fixed set of num_stragglers workers delivers only "
                  "every `period` rounds (defaults to τ+1: maximally "
                  "stale but never dropped)")
def straggler_fixed(*, num_workers, staleness_bound, num_stragglers: int = 2,
                    period: int | None = None, **_kw) -> ArrivalSchedule:
    period = (staleness_bound + 1) if period is None else period
    period = max(1, period)

    def arrive(key, round_index, byz_mask):
        del byz_mask
        slow = _workers(num_workers, key) < num_stragglers
        return torch.logical_or(~slow, torch.tensor(
            int(round_index) % period == 0, device=key.device))

    return ArrivalSchedule("straggler_fixed", num_workers, staleness_bound,
                           arrive)


@register_arrival("straggler_rotating",
                  "a fresh random num_stragglers-subset misses each round "
                  "(transient network jitter — the realistic production "
                  "regime)")
def straggler_rotating(*, num_workers, staleness_bound,
                       num_stragglers: int = 2, **_kw) -> ArrivalSchedule:
    from repro_torch.core.byzantine import sample_byzantine_mask

    def arrive(key, round_index, byz_mask):
        del byz_mask
        # decorrelated from the attack schedule's draw on the same key
        slow = sample_byzantine_mask(
            prng.fold_in(key, 31), num_workers, num_stragglers,
            rotate=True, round_index=round_index)
        return ~slow

    return ArrivalSchedule("straggler_rotating", num_workers,
                           staleness_bound, arrive)


@register_arrival("partition",
                  "a worker block drops off the network for a round window "
                  "[start_round, start_round+length) — ages past τ and is "
                  "hard-dropped until the partition heals")
def partition(*, num_workers, staleness_bound, block_start: int = 0,
              block_size: int = 2, start_round: int = 5, length: int = 10,
              **_kw) -> ArrivalSchedule:
    def arrive(key, round_index, byz_mask):
        del byz_mask
        idx = _workers(num_workers, key)
        in_block = (idx >= block_start) & (idx < block_start + block_size)
        t = int(round_index)
        in_window = start_round <= t < start_round + length
        return ~(in_block & in_window)

    return ArrivalSchedule("partition", num_workers, staleness_bound, arrive)


@register_arrival("byzantine_max_stale",
                  "adversarial asynchrony: Byzantine workers choose zero "
                  "staleness (fresh poison at full weight every round) "
                  "while delaying every honest worker to the bound τ — "
                  "honest mass decays as discount^age, so large τ lets "
                  "stale-poisoning win (the pinned break point)")
def byzantine_max_stale(*, num_workers, staleness_bound,
                        **_kw) -> ArrivalSchedule:
    period = staleness_bound + 1

    def arrive(key, round_index, byz_mask):
        # honest worker j refreshes only when (t + j) % (τ+1) == 0, so the
        # honest ages spread over 0..τ; the colluders always deliver
        stagger = (int(round_index) + _workers(num_workers, key)) \
            % period == 0
        return torch.logical_or(byz_mask.to(torch.bool), stagger)

    return ArrivalSchedule("byzantine_max_stale", num_workers,
                           staleness_bound, arrive)
