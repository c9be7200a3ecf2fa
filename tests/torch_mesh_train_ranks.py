"""Rank bodies of the port's mesh-train tests.

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  ``run_cases`` builds
the (4, 2) ("data", "model") mesh and the (2, 2, 2) ("pod", "data",
"model") mesh over the same 8 ranks, and runs each case twice under its
mesh; a case is a dict with ``kind``:

* ``"step"``: ``make_group_train_step`` on the mesh for ``len(batches)``
  steps, from the full ``params`` (numpy) cut to storage blocks on
  ``device`` (default the CPU);
  ``variant`` "shard_local" (``stacked_grad_shardings``, the reference's
  ``grad_shard_spec`` at ``target_backend``) or "gathered"
  (``gathered_grad_shardings``, its ``num_shards`` set to 1); the
  result: each step's metrics, the round kernel's launches, the storage
  blocks, the params and optimizer state gathered whole (rank 0 only),
  and whether every rank gathered the same bits; on the
  ``int8_stochastic`` wire also, each step, whether the step's payload
  is bit for bit the cut of the unsharded encode of its own stack
  gathered whole, each leaf's largest scale, and the first step's ``q``
  gathered whole (rank 0 only); ``fault`` "wrong_key" encodes with
  another key than the step's;
* ``"grad"``: ``model.loss_fn`` of the reduced ``arch`` on the compute
  layout gathered from the storage blocks (``sharding.compute_params``),
  its gradient under ``meshctx.param_sums_deferred`` taken back to the
  storage blocks (``sharding.storage_grads``), as the step does: the
  loss and the storage leaves' gradients gathered whole (rank 0 only);
* ``"aggregate"``: the ``attack`` and the ``rc`` aggregation of the whole
  stacked ``grads`` (numpy) cut by ``stacked_grad_shardings`` on the 2D
  layout (``shard_map`` mode): the rank's aggregate blocks; with
  ``gathered`` the blocks gathered whole first and aggregated whole
  (rank 0 returns it; every rank whether all hold the same bits);
* ``"int8"``: the ``int8_stochastic`` encode of the whole stacked
  ``grads`` (with ``extra`` leaves, the ``bf16`` ones cast) cut by
  ``stacked_grad_shardings`` on the 2D layout (``shard_map`` mode): the
  rank's ``q`` blocks and the scales; ``fault`` plants one:
  ``"block_keys"`` draws each block from the leaf's key folded by the
  rank (not its block of the whole draw), ``"block_amax"`` scales by the
  block's own maxima (not the whole leaf's);
* ``"clip"``: AdamW's update with a global clip norm on the 2D layout,
  the gradient and the params rows 0 and 1 of the stacked ``grads``;
* ``"roundtrip"``: ``storage_params`` then ``gather_params`` of every
  named reduced architecture, and the cut and the gather of the
  ``param_specs`` blocks: whether each gives back the params.

The storage layout is ``param_specs``: the reference's rules with FSDP
from ``min_fsdp_elems`` elements a leaf (the cases' 4096, so that the
reduced dense leaves are cut over ``data`` too).  A result carries
``repeat_equal``: whether the second run gave the same
bits (the round trip, an identity, and a case with ``repeat`` False run
once).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import byzantine, compression
from repro_torch.core import robust_train as rt
from repro_torch.core import shard_aggregation as sa
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import meshctx, model

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _cfg(case):
    return configs.get_config(case["arch"]).reduced().with_(
        **case.get("overrides", {}))


def _optimizer(case):
    return (optim.adamw(case["lr"]) if case["opt"] == "adamw"
            else optim.sgd(case["lr"]))


def param_specs(tree, mesh, cfg, min_fsdp_elems):
    """``param_partition_spec`` of every leaf of ``tree``, FSDP from
    ``min_fsdp_elems`` elements a leaf."""
    return sharding._map_with_path(
        lambda p, leaf: sharding.param_partition_spec(
            p, leaf, mesh, cfg, min_fsdp_elems=min_fsdp_elems), tree)


def stacked_specs(specs):
    """The (k, *param) stacked gradients' specs of ``specs``."""
    return sharding.map_specs(lambda _, __, s: (None,) + s, specs, specs)


def _same_everywhere(tree, mesh) -> bool:
    """Whether every rank of the mesh holds the same bits of ``tree``."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8)
                      for t in tree_leaves(tree)])
    parts = meshctx._parts(flat, mesh, meshctx.all_axes(mesh))
    return all(torch.equal(parts[0], p) for p in parts[1:])


class _Wire:
    """Records the ``int8_stochastic`` payloads a step encodes (installed
    in the codec registry for a ``with`` block): for each, whether it is
    the cut of the unsharded encode of the stack gathered whole (by
    ``stacked``, the stack's specs on ``mesh``; None: the stack is
    whole), its scales, and its ``q`` gathered whole.  ``wrong_key``
    encodes with another key (a planted fault)."""

    def __init__(self, mesh, stacked, wrong_key: bool = False):
        self.mesh, self.stacked, self.wrong_key = mesh, stacked, wrong_key
        self.records = []

    def encode(self, stacked, *, key=None, shard_spec=None):
        if self.wrong_key:
            key = prng.fold_in(key, 1)
        payload = self.real.encode(stacked, key=key, shard_spec=shard_spec)
        layout = shard_spec is not None and shard_spec.layout is not None
        whole = (sharding.gather_tree(stacked, self.stacked, self.mesh)
                 if layout else stacked)
        plain = self.real.encode(whole, key=key)
        q = payload["q"]
        if layout:
            plain = dict(q=sharding.cut_tree(plain["q"], self.stacked,
                                             self.mesh),
                         scale=plain["scale"])
            q = sharding.gather_tree(q, self.stacked, self.mesh)
        self.records.append(dict(
            equal=_equal(payload, plain),
            scale=tree_map(lambda x: x.max().cpu(), payload["scale"]),
            q=tree_map(lambda x: x.cpu(), q)))
        return payload

    def __enter__(self):
        self.real = compression.get_codec("int8_stochastic")
        compression._REGISTRY["int8_stochastic"] = dataclasses.replace(
            self.real, encode=self.encode)
        return self

    def __exit__(self, *exc):
        compression._REGISTRY["int8_stochastic"] = self.real


def _step(case, mesh):
    from repro_torch.kernels.geomed import round as rk
    cfg = _cfg(case)
    dev = torch.device(case.get("device", "cpu"))
    full = convert.lm_params_from_numpy(cfg, case["params"], dev)
    specs = param_specs(full, mesh, cfg, case["min_fsdp_elems"])
    storage = sharding.cut_tree(full, specs, mesh)
    spec = sharding.grad_shard_spec(mesh, cfg,
                                    target_backend=case["target_backend"])
    if case["variant"] == "gathered":
        gshard = sharding.gathered_grad_shardings(full, mesh)
        spec = dataclasses.replace(spec, num_shards=1)
    else:
        gshard = stacked_specs(specs)
    rc = rt.RobustConfig(**case["rc"])
    sched = None
    if case.get("schedule"):
        sched = byzantine.make_schedule(
            case["schedule"], num_workers=rc.num_workers,
            num_byzantine=rc.num_byzantine, attack=rc.attack)
    opt = _optimizer(case)
    step = steps.make_group_train_step(
        cfg, rc, opt, microbatches=case["microbatches"],
        grad_shardings=gshard, schedule=sched, shard_spec=spec,
        param_shardings=specs)
    ostate = opt.init(storage)
    astate = sched.init_state(dev) if sched else None
    launches = rk.round_aggregate_kernel.launches
    wire = _Wire(mesh, stacked_specs(specs),
                 wrong_key=case.get("fault") == "wrong_key")
    with wire:
        storage, ostate, rows = _steps(case, mesh, cfg, step, storage,
                                       ostate, astate, sched, dev)
    launches = rk.round_aggregate_kernel.launches - launches
    whole = tree_map(lambda t: t.cpu(),
                     sharding.gather_tree(storage, specs, mesh))
    ostate_whole = tree_map(lambda t: t.cpu(), type(ostate)(*[
        sharding.gather_tree(v, specs, mesh) if isinstance(v, dict) else v
        for v in ostate]))
    out = {"metrics": rows, "launches": launches,
           "same_everywhere": _same_everywhere(whole, mesh),
           "blocks": tree_map(lambda t: t.cpu(), storage)}
    if wire.records:
        out["wire_equal"] = [r["equal"] for r in wire.records]
        out["scale"] = tree_map(lambda *x: torch.stack(x).max(),
                                *[r["scale"] for r in wire.records])
    if mesh.rank == 0:
        out.update(params=whole, opt_state=ostate_whole)
        if wire.records:
            out["q0"] = wire.records[0]["q"]
    return out


def _steps(case, mesh, cfg, step, storage, ostate, astate, sched, dev):
    """The case's steps -> (storage, optimizer state, metrics rows)."""
    rows = []
    for t, tokens in enumerate(case["batches"]):
        tok = torch.as_tensor(np.asarray(tokens)).long().to(dev)
        batch = sharding.local_train_batch(
            {"tokens": tok, "labels": torch.roll(tok, -1, -1)}, mesh, cfg)
        key = prng.PRNGKey(case["seed"] + t, device=dev)
        if sched is None:
            storage, ostate, m = step(storage, ostate, batch, key, t)
        else:
            storage, ostate, m, astate = step(storage, ostate, batch, key,
                                              t, astate)
        rows.append({k: v.detach().cpu() for k, v in m.items()})
    return storage, ostate, rows


def _grad(case, mesh):
    cfg = _cfg(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    specs = param_specs(full, mesh, cfg, case["min_fsdp_elems"])
    storage = sharding.cut_tree(full, specs, mesh)
    tok = torch.as_tensor(np.asarray(case["tokens"])).long()
    B, T = tok.shape
    batch = sharding.local_batch(
        {"tokens": tok, "labels": torch.roll(tok, -1, -1)}, mesh, cfg)
    plans = sharding.compute_plans(storage, specs, mesh, cfg, batch=B, seq=T)
    compute = sharding.compute_params(storage, plans, mesh)
    with meshctx.param_sums_deferred():
        loss, partials = steps._value_and_grad(compute, batch, cfg)
    grads = sharding.storage_grads(partials, plans, mesh)
    out = {"loss": loss, "blocks": grads}
    whole = sharding.gather_tree(grads, specs, mesh)
    if mesh.rank == 0:
        out["grads"] = whole
    return out


def layout_of(case, mesh):
    """(stacked specs tree, the whole stacked grads as torch) of an
    aggregate case: ``grads`` with the storage layout's specs, then the
    ``extra`` leaves {name: (array, param spec)}, the ``bf16`` top-level
    paths cast to bfloat16."""
    cfg = _cfg(case)
    grads = tree_map(lambda a: torch.as_tensor(np.asarray(a)),
                     case["grads"])
    shapes = tree_map(lambda t: t[0], grads)
    specs = param_specs(shapes, mesh, cfg, case["min_fsdp_elems"])
    for name, (a, spec) in case.get("extra", {}).items():
        grads[name] = torch.as_tensor(np.asarray(a))
        specs[name] = tuple(spec)
    for path in case.get("bf16", ()):
        node = grads
        for n in path[:-1]:
            node = node[n]
        node[path[-1]] = node[path[-1]].to(torch.bfloat16)
    return stacked_specs(specs), grads


def aggregate_case(case, stacked_grads, spec):
    """The attack and the aggregation of ``stacked_grads`` with ``spec``
    installed as the layout (the attack reads it)."""
    rc = rt.RobustConfig(**case["rc"])
    key = prng.PRNGKey(case["seed"])
    with sa.use_layout(spec if spec is not None and spec.layout is not None
                       else None):
        mask = byzantine.sample_byzantine_mask(
            key, rc.num_workers, rc.num_byzantine, rotate=True,
            round_index=0)
        reported = byzantine.get_attack(rc.attack)(stacked_grads, mask, key)
        return rt.aggregate_reported(reported, rc, key=key, shard_spec=spec)


def _aggregate(case, mesh):
    stacked, grads = layout_of(case, mesh)
    blocks = sharding.cut_tree(grads, stacked, mesh)
    if case.get("gathered"):
        whole = sharding.gather_tree(blocks, stacked, mesh)
        spec = sa.ShardSpec(num_shards=1, target_backend="cuda")
        agg = aggregate_case(case, whole, spec)
        out = {"same_everywhere": _same_everywhere(agg, mesh)}
        if mesh.rank == 0:
            out["agg"] = agg
        return out
    spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                          tuple(mesh.shape.items()))
    return {"agg": aggregate_case(case, blocks, spec)}


def int8_encode(case, stacked_grads, spec):
    """The ``int8_stochastic`` payload of ``stacked_grads`` under
    ``spec`` with the case's key."""
    return compression.get_codec("int8_stochastic").encode(
        stacked_grads, key=prng.PRNGKey(case["seed"]), shard_spec=spec)


def _int8(case, mesh):
    stacked, grads = layout_of(case, mesh)
    blocks = sharding.cut_tree(grads, stacked, mesh)
    spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                          tuple(mesh.shape.items()))
    fault = case.get("fault")
    real = prng.uniform_at, compression._layout_amax
    if fault == "block_keys":
        prng.uniform_at = lambda k, shape, idx: prng.uniform(
            prng.fold_in(k, mesh.rank), (idx.numel(),)).reshape(idx.shape)
    elif fault == "block_amax":
        compression._layout_amax = lambda gf, _spec: torch.amax(
            torch.abs(gf), dim=tuple(range(1, gf.ndim)))
    try:
        return int8_encode(case, blocks, spec)
    finally:
        prng.uniform_at, compression._layout_amax = real


def clip_case(case, grads, params, spec):
    """AdamW's update with its global clip norm (``case["clip"]``) of the
    param-shaped ``grads``, with ``spec`` installed as the layout."""
    opt = optim.adamw(1e-3, grad_clip_norm=case["clip"])
    with sa.use_layout(spec):
        return opt.update(grads, opt.init(params), params)[0]


def _clip(case, mesh):
    stacked, grads = layout_of(case, mesh)
    spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                          tuple(mesh.shape.items()))
    blocks = sharding.cut_tree(grads, stacked, mesh)
    return {"update": clip_case(case, tree_map(lambda g: g[0], blocks),
                                tree_map(lambda g: g[1], blocks), spec)}


def _roundtrip(case, mesh):
    ok = {}
    for arch in case["archs"]:
        cfg = configs.get_config(arch).reduced()
        full = model.init(0, cfg, device="cpu")
        specs = param_specs(full, mesh, cfg, case["min_fsdp_elems"])
        backs = (sharding.gather_params(
            sharding.storage_params(full, mesh, cfg), mesh, cfg),
            sharding.gather_tree(sharding.cut_tree(full, specs, mesh),
                                 specs, mesh))
        ok[arch] = torch.tensor(all(
            torch.equal(a, b) for back in backs
            for a, b in zip(tree_leaves(full), tree_leaves(back))))
    return ok


KINDS = {"step": _step, "grad": _grad, "aggregate": _aggregate,
         "int8": _int8, "clip": _clip, "roundtrip": _roundtrip}


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def run_cases(rank: int, world: int, cases: dict, meshes=None):
    """{case id: this rank's result} for every case, each run twice;
    ``meshes`` (default ``MESHES``) names the meshes built over the
    ranks."""
    torch.set_num_threads(1)
    meshes = {name: mesh_lib.make_mesh(shape, axes)
              for name, (shape, axes) in (meshes or MESHES).items()}
    out = {}
    for cid, case in cases.items():
        mesh = meshes[case.get("mesh", "4x2")]
        with meshctx.set_mesh(mesh):
            first = KINDS[case["kind"]](case, mesh)
            if case["kind"] != "roundtrip" and case.get("repeat", True):
                again = KINDS[case["kind"]](case, mesh)
                first["repeat_equal"] = _equal(first, again)
        out[cid] = first
    out["coords"] = {name: dict(m.coords) for name, m in meshes.items()}
    return out
