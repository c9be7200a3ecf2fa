"""Rank bodies of the mesh tests of the hybrid, audio and vlm families
(tests/test_torch_mesh_families.py).

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  ``run_cases`` builds
a (2, 2) and a (1, 4) ("data", "model") mesh over the same 4 ranks and
runs each case under the mesh it names; a case is a dict with ``kind``:

* ``"model"``: ``model.loss_fn`` of the reduced ``arch`` (the config
  fields in ``overrides``) on the whole ``params`` (numpy) cut to the
  compute layout (``sharding.local_params``) and the global ``batch``
  (numpy) cut to the rank's block (``sharding.local_batch``), its
  gradients gathered whole (rank 0 only), run twice; with ``fault`` the
  Mamba2 gated norm is this rank's channels' alone (a planted fault);
* ``"prefill"``: ``steps.make_prefill_step`` on the same inputs: this
  rank's hidden states;
* ``"mamba"``: one Mamba2 block (``mamba.apply``, ``spec``) on
  ``device`` (default the CPU): the whole ``params`` (numpy) cut to the
  rank's channels, the stream ``x`` (B, T, D) whole on every rank; the
  loss sum(out ** 2) / |model| a rank (the copies' sum is one process's
  sum(out ** 2)); the output, the TP leaves' gradients gathered whole and
  the other leaves' and x's psum'd over ``model``;
* ``"step"``: ``make_group_train_step`` on the mesh, SGD, for
  ``len(batches)`` steps from the storage blocks (FSDP from
  ``min_fsdp_elems`` elements a leaf) of ``params``, ``variant``
  "shard_local" or "gathered": each step's metrics, and the params
  gathered whole (rank 0 only) and whether every rank gathered the same
  bits.

A result is a dict of CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

import torch_mesh_train_ranks as mtr
from repro_torch import configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import robust_train as rt
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import layers, mamba, meshctx, model

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _cfg(case):
    return configs.get_config(case["arch"]).reduced().with_(
        **case.get("overrides", {}))


def _batch(tree):
    """A numpy batch as tensors: integer leaves as int64."""
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).long()
                    if np.issubdtype(np.asarray(a).dtype, np.integer)
                    else torch.as_tensor(np.asarray(a)), tree)


def compute_specs(params, mesh, cfg):
    """``sharding.compute_spec`` of every leaf of ``params``."""
    return sharding._map_with_path(
        lambda p, t: sharding.compute_spec(p, tuple(t.shape), mesh, cfg),
        params)


def _rank_norm(params, y, mesh, width):
    """The planted fault: the gated norm over the rank's channels only."""
    return layers.rmsnorm(params, y)


def _model(case, mesh):
    cfg = _cfg(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    specs = compute_specs(full, mesh, cfg)
    local = tree_map(lambda t: t.detach().clone().requires_grad_(),
                     sharding.cut_tree(full, specs, mesh))
    batch = sharding.local_batch(_batch(case["batch"]), mesh, cfg)
    real = mamba._gate_norm
    if case.get("fault"):
        mamba._gate_norm = _rank_norm
    try:
        loss = model.loss_fn(local, batch, cfg)
        loss.backward()
    finally:
        mamba._gate_norm = real
    grads = sharding.gather_tree(tree_map(lambda t: t.grad, local), specs,
                                 mesh)
    out = {"loss": loss.detach()}
    if mesh.rank == 0:
        out["grads"] = grads
    return out


def _prefill(case, mesh):
    cfg = _cfg(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    local = sharding.local_params(full, mesh, cfg)
    batch = sharding.local_batch(_batch(case["batch"]), mesh, cfg)
    return {"h": steps.make_prefill_step(cfg)(local, batch)}


def _mamba(case, mesh):
    dev = torch.device(case.get("device", "cpu"))
    spec = mamba.MambaSpec(**case["spec"])
    full = tree_map(lambda a: torch.as_tensor(np.asarray(a), device=dev),
                    case["params"])
    specs = sharding._map_with_path(
        lambda p, t: tuple("model" if d == t.ndim + mamba.tp_dim(p)
                           else None for d in range(t.ndim))
        if mamba.tp_dim(p) is not None else (None,) * t.ndim, full)
    local = tree_map(lambda t: t.requires_grad_(),
                     sharding.cut_tree(full, specs, mesh))
    x = torch.as_tensor(np.asarray(case["x"]), device=dev).requires_grad_()
    out, _ = mamba.apply(local, spec, x)
    (torch.sum(out * out) / meshctx.model_size(mesh)).backward()
    grads = sharding._map_with_path(
        lambda p, t: t.grad if mamba.tp_dim(p) is not None
        else meshctx.psum(t.grad, "model"), local)
    return {"out": out.detach().cpu(),
            "x_grad": meshctx.psum(x.grad, "model").cpu(),
            "grads": tree_map(lambda t: t.cpu(),
                              sharding.gather_tree(grads, specs, mesh))}


def _step(case, mesh):
    cfg = _cfg(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    specs = mtr.param_specs(full, mesh, cfg, case["min_fsdp_elems"])
    storage = sharding.cut_tree(full, specs, mesh)
    spec = sharding.grad_shard_spec(mesh, cfg, target_backend="cpu")
    if case["variant"] == "gathered":
        gshard = sharding.gathered_grad_shardings(full, mesh)
        spec = dataclasses.replace(spec, num_shards=1)
    else:
        gshard = mtr.stacked_specs(specs)
    opt = optim.sgd(case["lr"])
    step = steps.make_group_train_step(
        cfg, rt.RobustConfig(**case["rc"]), opt, grad_shardings=gshard,
        shard_spec=spec, param_shardings=specs)
    ostate = opt.init(storage)
    rows = []
    for t, batch in enumerate(case["batches"]):
        local = sharding.local_train_batch(_batch(batch), mesh, cfg)
        storage, ostate, m = step(storage, ostate, local,
                                  prng.PRNGKey(case["seed"] + t), t)
        rows.append({k: v.detach() for k, v in m.items()})
    whole = sharding.gather_tree(storage, specs, mesh)
    out = {"metrics": rows, "same_everywhere": mtr._same_everywhere(whole,
                                                                     mesh)}
    if mesh.rank == 0:
        out["params"] = whole
    return out


# one Mamba2 block: d_model 64, 8 heads of 16, state 16, chunks of 16
MAMBA_SPEC = dict(d_model=64, d_state=16, head_dim=16, chunk=16)


def mamba_inputs(spec, batch=2, seq=64, seed=5):
    """A ``"mamba"`` case's block params (numpy, drawn on the CPU) and its
    stream x (batch, seq, d_model)."""
    params = mamba.init(torch.Generator().manual_seed(seed),
                        mamba.MambaSpec(**spec), dtype=torch.float32)
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, seq, spec["d_model"]))
    return dict(spec=spec, x=x.astype(np.float32),
                params=tree_map(lambda t: t.numpy(), params))


def mamba_one_process(case, device="cpu"):
    """One process's (out, x's gradient, the params' gradients) of the
    block of a ``"mamba"`` case on ``device``, the loss sum(out ** 2); on
    the CPU."""
    params = tree_map(lambda a: torch.as_tensor(a, device=device)
                      .requires_grad_(), case["params"])
    x = torch.as_tensor(case["x"], device=device).requires_grad_()
    out, _ = mamba.apply(params, mamba.MambaSpec(**case["spec"]), x)
    torch.sum(out * out).backward()
    return out.detach().cpu(), x.grad.cpu(), tree_map(
        lambda t: t.grad.cpu(), params)


KINDS = {"model": _model, "prefill": _prefill, "mamba": _mamba,
         "step": _step}


def run_cases(rank: int, world: int, cases: dict, meshes=None):
    """{case id: this rank's result}; ``meshes`` (default ``MESHES``)
    names the meshes built over the ranks; the model cases run twice,
    with ``repeat_equal``: whether the second run gave the same bits."""
    torch.set_num_threads(1)
    meshes = {name: mesh_lib.make_mesh(shape, axes)
              for name, (shape, axes) in (meshes or MESHES).items()}
    out = {}
    for cid, case in cases.items():
        mesh = meshes[case["mesh"]]
        with meshctx.set_mesh(mesh):
            first = KINDS[case["kind"]](case, mesh)
            if case["kind"] == "model":
                again = KINDS[case["kind"]](case, mesh)
                first["repeat_equal"] = all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                      tree_leaves(again)))
        out[cid] = first
    out["coords"] = {name: dict(m.coords) for name, m in meshes.items()}
    return out
