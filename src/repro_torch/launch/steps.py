"""Train and serve steps (port of ``repro.launch.steps``).

Two gradient paths implement the paper's Algorithm 2:

* **worker mode** (``repro_torch.core.robust_train``): one gradient per
  worker (``torch.func.vmap`` of ``grad``), the attack at worker
  granularity; faithful to the paper line by line.
* **group mode** (here, ``make_group_train_step``): gradients computed
  directly per batch group, one group at a time on plain autograd:
  mean-of-means is the pooled mean, so the k honest batch means are
  worker mode's, while peak memory drops from (m, P) to (k, P).  The
  corruption is injected at batch-mean granularity, and aggregation
  dispatches through ``robust_train.aggregate_reported``, so
  ``rc.aggregator``, ``rc.round_backend`` and an ``AttackSchedule`` are
  first-class.  Both modes honour ``cfg.remat``
  (``models.blocks.maybe_remat``), with the same numbers as without it.

The serve steps (``make_prefill_step``, ``make_serve_step``) run under
``torch.no_grad``.  A step sets the port's matmul precision
(``_device.set_precision``) and runs on whatever device its params lie
on.  The reference's abstract input specs (``ShapeDtypeStruct``) wait for
the dry-run tooling (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import byzantine
from repro_torch.core.geometric_median import median
from repro_torch.core.robust_train import RobustConfig, aggregate_reported
from repro_torch.models import model as model_lib


# ---------------------------------------------------------------------------
# train steps

def _value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, grads) of ``model.loss_fn`` on plain autograd; the grads
    in the params' dtypes."""
    leaves, spec = tree_flatten(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss = model_lib.loss_fn(tree_unflatten(ps, spec), batch, cfg)
        grads = torch.autograd.grad(loss, ps)
    return loss.detach(), tree_unflatten(list(grads), spec)


def _stack_into(out, i: int, tree, k: int):
    """Write ``tree`` into row ``i`` of the stacked (k, ...) tree ``out``
    (allocated at the first row): no list of k trees beside the stack."""
    if out is None:
        out = tree_map(lambda x: torch.empty((k, *x.shape), dtype=x.dtype,
                                             device=x.device), tree)
    for dst, src in zip(tree_leaves(out), tree_leaves(tree)):
        dst[i].copy_(src)
    return out


def make_group_train_step(cfg: ModelConfig, rc: RobustConfig, optimizer, *,
                          microbatches: int = 1, grad_shardings=None,
                          schedule: byzantine.AttackSchedule | None = None,
                          shard_spec=None):
    """Group-mode robust train step.

    ``rc.num_workers`` is read as k, the number of batch groups: the batch
    leaves are (k, B/k, ...), and the attack mask has k entries with
    ``rc.num_byzantine`` contaminated groups.  Each group's loss and
    gradient come from ``model.loss_fn`` on plain autograd, one group at a
    time; with ``microbatches`` > 1 a group's batch (every leaf: tokens,
    labels, and vlm's patches or audio's frames) is split and its
    gradients summed in float32, then averaged (the grads are then
    float32, as in the reference).  ``shard_spec`` reaches
    ``aggregate_reported``.

    Without ``schedule``: ``train_step(params, opt_state, batch, key,
    round_index) -> (params, opt_state, metrics)``; with one, the step also
    takes and returns the adversary's carried ``attack_state``.  Metrics:
    ``loss_mean``, ``loss_median``, ``agg_grad_norm``, ``byz_count``.
    ``grad_shardings`` (the stacked gradients model-sharded on the mesh,
    ``launch.sharding.stacked_grad_shardings``) is ROADMAP Queue 1 item
    16.11."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings lays the stacked gradients out over the mesh's "
            "model axis and aggregates them shard-local: ROADMAP Queue 1 "
            "item 16.11")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    k = rc.num_workers
    attack = byzantine.get_attack(rc.attack)
    attack_kwargs = dict(rc.attack_kwargs)

    def group_value_and_grad(params, group_batch):
        if microbatches == 1:
            return _value_and_grad(params, group_batch, cfg)

        def split(x):
            n = x.shape[0]
            if n % microbatches != 0:
                raise ValueError(f"a group's batch of {n} does not split "
                                 f"into {microbatches} microbatches")
            return x.reshape((microbatches, n // microbatches) + x.shape[1:])

        mb = tree_map(split, group_batch)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        l_acc = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        for i in range(microbatches):
            loss, g = _value_and_grad(params, tree_map(lambda x: x[i], mb),
                                      cfg)
            g_acc = tree_map(lambda a, x: a + x.to(torch.float32), g_acc, g)
            l_acc = l_acc + loss
        inv = 1.0 / microbatches
        return l_acc * inv, tree_map(lambda x: x * inv, g_acc)

    def _step_core(params, opt_state, batch, key, round_index, attack_state):
        _device.set_precision()
        with torch.no_grad():
            # the k groups one after another: one group's activations
            # live at a time, its gradient kept apart in the (k, ...) stack
            grads, losses = None, []
            for g in range(k):
                loss, grad = group_value_and_grad(
                    params, tree_map(lambda x: x[g], batch))
                grads = _stack_into(grads, g, grad, k)
                losses.append(loss)
                del grad
            losses = torch.stack(losses)
            if schedule is None:
                mask = byzantine.sample_byzantine_mask(
                    key, k, rc.num_byzantine, rotate=rc.rotate_byzantine,
                    round_index=round_index)
                reported = attack(grads, mask, key, **attack_kwargs)
            else:
                reported, mask, attack_state = schedule.apply(
                    grads, key, round_index, attack_state)
            del grads
            agg = aggregate_reported(reported, rc, key=key,
                                     shard_spec=shard_spec)
            del reported
            updates, opt_state = optimizer.update(agg, opt_state, params)
            params = tree_map(lambda p, u: (p + u).to(p.dtype), params,
                              updates)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for g in tree_leaves(agg)))
            metrics = {"loss_mean": torch.mean(losses),
                       "loss_median": median(losses),
                       "agg_grad_norm": gnorm,
                       "byz_count": torch.sum(mask.to(torch.int32))}
        return params, opt_state, metrics, attack_state

    if schedule is None:
        def train_step(params, opt_state, batch, key, round_index):
            params, opt_state, metrics, _ = _step_core(
                params, opt_state, batch, key, round_index, None)
            return params, opt_state, metrics
    else:
        def train_step(params, opt_state, batch, key, round_index,
                       attack_state):
            return _step_core(params, opt_state, batch, key, round_index,
                              attack_state)

    return train_step


def make_mean_train_step(cfg: ModelConfig, optimizer, *,
                         microbatches: int = 1):
    """Failure-free baseline (the paper's Algorithm 1 at LM scale): the
    same pipeline with k = 1, mean aggregation, no attack."""
    rc = RobustConfig(num_workers=1, num_byzantine=0, num_batches=1,
                      aggregator="mean", attack="none", trim_multiplier=None)
    return make_group_train_step(cfg, rc, optimizer,
                                 microbatches=microbatches)


# ---------------------------------------------------------------------------
# serve steps


def make_prefill_step(cfg: ModelConfig, *, plain: bool = False):
    """(params, {"tokens": (B, T)} + vlm's "patches" (B, P, D) or audio's
    "frames" (B, S, D), which the model casts to ``cfg.dtype``) -> hidden
    states (B, T, D) of the text positions.  On CUDA the attention core is
    the flash kernel; ``plain=True`` keeps the reference's plain path
    (``attention_core_blocked`` above 2048 for self-attention)."""
    def prefill_step(params, batch):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.prefill(params, cfg, batch, plain=plain)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens (B, 1), positions (B,)) -> (logits (B, 1, V),
    state); the KV cache is updated in place."""
    def serve_step(params, state, tokens, positions):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.decode_step(params, cfg, state, tokens,
                                         positions)
    return serve_step
