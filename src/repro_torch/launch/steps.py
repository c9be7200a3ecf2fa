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

Under a model mesh (``meshctx.set_mesh``) with ``grad_shardings`` the
group step runs on the mesh's ranks (``_MeshLayout``): params and
optimizer state are the rank's storage blocks
(``sharding.storage_params``), the batch the rank's block
(``sharding.local_train_batch``); the compute layout is gathered once a
step, each group's gradient reduce-scattered into the storage blocks,
and the stacked (k, *block) gradients are attacked and aggregated on the
2D layout (``shard_aggregation.layout_spec``) where the spec is
partitioned, or gathered whole first, where it is not, so that the round
kernel aggregates them on every rank.  A report wire encodes them in that
layout: the ``int8_stochastic`` payload is the reference's unsharded one
either way (on the layout, each rank's cut of it).

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
from repro_torch.core import shard_aggregation as sa
from repro_torch.core.geometric_median import median
from repro_torch.core.robust_train import RobustConfig, aggregate_reported
from repro_torch.launch import sharding
from repro_torch.models import meshctx
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


def _microbatch_mean(parts, microbatches: int):
    """A group's (loss, grads) from its ``microbatches`` (loss, grads)
    pairs, taken one at a time: one pair as it is; several summed in
    float32 from zero, then averaged (the grads are then float32, as in
    the reference)."""
    if microbatches == 1:
        return next(iter(parts))
    f32 = torch.float32
    g_acc = l_acc = None
    for loss, g in parts:
        if g_acc is None:
            g_acc = tree_map(lambda x: torch.zeros(
                x.shape, dtype=f32, device=x.device), g)
            l_acc = torch.zeros((), dtype=f32, device=loss.device)
        g_acc = tree_map(lambda a, x: a + x.to(f32), g_acc, g)
        l_acc = l_acc + loss
        del g
    inv = 1.0 / microbatches
    return l_acc * inv, tree_map(lambda x: x * inv, g_acc)


def _stack_into(out, i: int, tree, k: int):
    """Write ``tree`` into row ``i`` of the stacked (k, ...) tree ``out``
    (allocated at the first row): no list of k trees beside the stack."""
    if out is None:
        out = tree_map(lambda x: torch.empty((k, *x.shape), dtype=x.dtype,
                                             device=x.device), tree)
    for dst, src in zip(tree_leaves(out), tree_leaves(tree)):
        dst[i].copy_(src)
    return out


class _MeshLayout:
    """The mesh step's layouts on the ambient ``mesh``: the params'
    storage specs (``param_shardings``, default the reference's
    ``param_shardings`` of the config's shapes), the stacked gradients'
    layout spec, and whether the stacked gradients are gathered whole
    before the attack (``gather``: the gathered variant, or a spec that
    is not partitioned, where GSPMD gathers them for the round kernel).

    ``grad_shardings`` must be ``stacked_grad_shardings`` of the storage
    layout or ``gathered_grad_shardings``; ``shard_spec`` the reference's
    ``gspmd`` spec (``grad_shard_spec``, ``num_shards`` 1 or |model|) or
    None.  Any other spec would not describe the blocks: refused."""

    def __init__(self, cfg, mesh, grad_shardings, shard_spec,
                 param_shardings):
        self.mesh = mesh
        if param_shardings is None:
            param_shardings = sharding.param_shardings(
                sharding.param_shapes(cfg), mesh, cfg)
        self.specs = param_shardings
        stacked = sharding.map_specs(lambda _, __, s: (None,) + tuple(s),
                                     param_shardings, param_shardings)
        got = sharding.spec_leaves(param_shardings, grad_shardings)
        gathered = not any(meshctx.spec_axes(s) for s in got)
        if not gathered and got != sharding.spec_leaves(param_shardings,
                                                        stacked):
            raise ValueError(
                "grad_shardings lays the stacked gradients out as neither "
                "their storage blocks (stacked_grad_shardings) nor whole "
                "(gathered_grad_shardings)")
        model_n = meshctx.model_size(mesh)
        if shard_spec is not None and (
                shard_spec.mode != "gspmd" or shard_spec.layout is not None
                or shard_spec.num_shards not in (1, model_n)):
            raise ValueError(
                f"the mesh step takes the reference's gspmd ShardSpec "
                f"(num_shards 1 or {model_n}) and lays its blocks out "
                f"itself; got {shard_spec}")
        self.stacked_specs = stacked
        partitioned = sa.is_partitioned(shard_spec)
        self.gather = gathered or not partitioned
        self.shard_spec = shard_spec
        target = sa.target_backend_of(shard_spec)
        self.layout = sa.layout_spec(
            sharding.spec_leaves(param_shardings, stacked),
            tuple(mesh.shape.items()), target_backend=target)

    def batch(self, group_batch, microbatches: int):
        """A group's (microbatches, rows, T) blocks: microbatch i is the
        rank's block of the unsharded step's microbatch i (the rows are
        gathered over the data axes first, tokens only)."""
        if microbatches == 1:
            return tree_map(lambda x: x[None], group_batch)
        mesh = self.mesh
        daxes = meshctx.data_axes(mesh)
        spec = (None, meshctx.dspec(mesh))

        def split(x):
            rows = meshctx._all_gather(x, mesh, daxes, 0)
            n = rows.shape[0]
            if n % (microbatches * meshctx.data_size(mesh)) != 0:
                raise ValueError(
                    f"a group's batch of {n} does not split into "
                    f"{microbatches} microbatches over "
                    f"{meshctx.data_size(mesh)} data ranks")
            mb = rows.reshape((microbatches, n // microbatches)
                              + rows.shape[1:])
            return meshctx.cut(mb, spec + (None,) * (x.ndim - 1),
                               mesh.coords, mesh.shape)

        return tree_map(split, group_batch)


def make_group_train_step(cfg: ModelConfig, rc: RobustConfig, optimizer, *,
                          microbatches: int = 1, grad_shardings=None,
                          schedule: byzantine.AttackSchedule | None = None,
                          shard_spec=None, param_shardings=None):
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

    ``grad_shardings`` runs the step on the ambient model mesh (a
    ``ValueError`` without one): ``sharding.stacked_grad_shardings`` of
    the storage layout for the shard-local variant, or
    ``sharding.gathered_grad_shardings`` for the gathered one, with the
    reference's ``shard_spec`` (``sharding.grad_shard_spec``, its
    ``num_shards`` set to 1 for the gathered variant, as the reference's
    dry run sets it).  Params and optimizer state are then the rank's
    storage blocks of ``param_shardings`` (default: the reference's
    ``param_shardings`` of the config's shapes) and the batch the rank's
    ``sharding.local_train_batch`` block; the step returns storage
    blocks."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    mesh_layout = None
    if grad_shardings is not None:
        mesh = meshctx.current_mesh()
        if mesh is None:
            raise ValueError(
                "grad_shardings lays the stacked gradients out on a model "
                "mesh: build the step under meshctx.set_mesh")
        mesh_layout = _MeshLayout(cfg, mesh, grad_shardings, shard_spec,
                                  param_shardings)
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
        return _microbatch_mean(
            (_value_and_grad(params, tree_map(lambda x: x[i], mb), cfg)
             for i in range(microbatches)), microbatches)

    def mesh_value_and_grad(compute, plans, group_batch):
        """A group's loss and its gradient in the storage blocks: each
        microbatch's reduce-scattered, then averaged."""
        mesh = mesh_layout.mesh
        mbs = mesh_layout.batch(group_batch, microbatches)

        def part(i):
            with meshctx.param_sums_deferred():
                loss, gc = _value_and_grad(
                    compute, tree_map(lambda x: x[i], mbs), cfg)
            return loss, sharding.storage_grads(gc, plans, mesh)

        return _microbatch_mean((part(i) for i in range(microbatches)),
                                microbatches)

    def attack_step(grads, key, round_index, attack_state):
        if schedule is None:
            mask = byzantine.sample_byzantine_mask(
                key, k, rc.num_byzantine, rotate=rc.rotate_byzantine,
                round_index=round_index)
            return attack(grads, mask, key, **attack_kwargs), mask, \
                attack_state
        return schedule.apply(grads, key, round_index, attack_state)

    def _step_core(params, opt_state, batch, key, round_index, attack_state):
        """On a mesh ``params`` and ``opt_state`` are the rank's storage
        blocks and ``batch`` its (k, rows, T) block."""
        _device.set_precision()
        lay = mesh_layout
        with torch.no_grad():
            if lay is None:
                def value_and_grad(group_batch):
                    return group_value_and_grad(params, group_batch)
            else:
                rows, seq = model_lib.stream_shape(
                    cfg, tree_map(lambda x: x[0], batch), lay.mesh)
                plans = sharding.compute_plans(
                    params, lay.specs, lay.mesh, cfg, seq=seq,
                    batch=rows // microbatches)
                compute = sharding.compute_params(params, plans, lay.mesh)

                def value_and_grad(group_batch):
                    return mesh_value_and_grad(compute, plans, group_batch)
            # the k groups one after another: one group's activations
            # live at a time, its gradient kept apart in the (k, ...) stack
            grads, losses = None, []
            for g in range(k):
                loss, grad = value_and_grad(tree_map(lambda x: x[g], batch))
                grads = _stack_into(grads, g, grad, k)
                losses.append(loss)
                del grad
            value_and_grad = compute = None     # the compute layout's params
            losses = torch.stack(losses)
            if lay is not None and not lay.gather:
                # shard-local: the attack and the aggregation on the blocks
                with sa.use_layout(lay.layout):
                    reported, mask, attack_state = attack_step(
                        grads, key, round_index, attack_state)
                    del grads
                    agg = aggregate_reported(reported, rc, key=key,
                                             shard_spec=lay.layout)
                gnorm = torch.sqrt(sa.sq_norm(lay.layout, tree_leaves(agg)))
            else:
                spec = shard_spec
                if lay is not None:
                    # gathered: the stacked blocks whole on every rank
                    grads = sharding.gather_tree(grads, lay.stacked_specs,
                                                 lay.mesh)
                    spec = lay.shard_spec
                reported, mask, attack_state = attack_step(
                    grads, key, round_index, attack_state)
                del grads

                def aggregate():
                    return aggregate_reported(reported, rc, key=key,
                                              shard_spec=spec)
                agg = aggregate() if lay is None else meshctx.one_card_turns(
                    lay.mesh, aggregate, tree_leaves(reported)[0].device)
                gnorm = torch.sqrt(sum(torch.sum(torch.square(
                    g.to(torch.float32))) for g in tree_leaves(agg)))
                if lay is not None:
                    agg = sharding.cut_tree(agg, lay.specs, lay.mesh)
            del reported
            with sa.use_layout(lay.layout if lay is not None else None):
                updates, opt_state = optimizer.update(agg, opt_state,
                                                      params)
            params = tree_map(lambda p, u: (p + u).to(p.dtype), params,
                              updates)
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
    (``attention_core_blocked`` above 2048 for self-attention).  Under an
    ambient mesh the params and the batch are the rank's
    (``sharding.local_params``, ``local_batch``) and so are the hidden
    states."""
    def prefill_step(params, batch):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.prefill(params, cfg, batch, plain=plain)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens (B, 1), positions (B,)) -> (logits (B, 1, V),
    state); the KV cache is updated in place.  Under an ambient mesh the
    params are the rank's, tokens and positions its rows and the state its
    block (``sharding.local_rows``, ``local_decode_state``)."""
    def serve_step(params, state, tokens, positions):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.decode_step(params, cfg, state, tokens,
                                         positions)
    return serve_step
