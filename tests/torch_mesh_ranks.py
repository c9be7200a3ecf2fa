"""Rank bodies of the port's model-mesh tests.

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  ``run_cases`` builds
the mesh, cuts each case's global numpy inputs to the rank's block and
runs the case twice; a case is a dict with ``kind``:

* ``"attention"``: ``attention.apply_sequence_parallel`` (``spec``,
  ``params``, ``x`` (B, T, D), ``q_block``, ``kv_block``), the loss
  sum(out ** 2) over the mesh, its gradients;
* ``"moe"``: ``moe.apply`` under the mesh (expert parallel; ``spec``,
  ``params``, ``x``), the loss sum(out ** 2) + aux, its gradients;
* ``"swiglu"``: ``layers.swiglu`` under the mesh (the SP+TP region;
  ``params``, ``x``), the loss sum(out ** 2), its gradients;
* ``"wkv"``: ``rwkv._wkv_dispatch`` (``r``, ``k``, ``v``, ``w`` (B, T,
  H, hd), ``u``, ``state``);
* ``"model"``: ``model.loss_fn`` of the reduced ``arch`` (with the
  config fields in ``overrides``) on ``params`` (the reference's init,
  numpy) and ``tokens`` (B, T), its gradients.

A result is a dict of tensors on the CPU (this rank's blocks, the
gradients of replicated params whole) with ``repeat_equal``: whether the
second run gave the same bits.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import attention, layers, meshctx, model, moe, rwkv


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh on a one-rank gloo group of this
    process, installed for a ``with`` block, the group destroyed after."""
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp}/rendezvous")
        try:
            with meshctx.set_mesh(mesh_lib.make_mesh((1, 1),
                                                     ("data", "model"))) as m:
                yield m
        finally:
            dist.destroy_process_group()


def block(a, mesh, *, seq: bool = True):
    """The rank's block of a global (B, T, ...) array: rows over the data
    axes, and with ``seq`` columns over ``model``."""
    t = torch.as_tensor(np.asarray(a))
    d, nd = mesh.index(meshctx.data_axes(mesh)), meshctx.data_size(mesh)
    t = t.chunk(nd, 0)[d]
    if seq:
        t = t.chunk(meshctx.model_size(mesh), 1)[mesh.coords["model"]]
    return t.contiguous()


def _mark(tree, flat, path=()):
    """``tree`` (numpy or torch leaves) as fresh leaf tensors that require
    grad, each also filed in ``flat`` under its "/"-joined path."""
    if isinstance(tree, dict):
        return {k: _mark(v, flat, path + (k,)) for k, v in tree.items()}
    leaf = torch.as_tensor(np.asarray(tree) if isinstance(tree, np.ndarray)
                           else tree).clone().requires_grad_()
    flat["/".join(path)] = leaf
    return leaf


def _grads(flat):
    return {f"grad/{k}": v.grad for k, v in flat.items()}


def _loss(out, mesh):
    return meshctx.psum(torch.sum(out * out), meshctx.all_axes(mesh),
                        mesh=mesh)


def _attention(case, mesh):
    spec = attention.AttentionSpec(**case["spec"])
    flat = {}
    leaves = _mark(case["params"], flat)
    x = block(case["x"], mesh).requires_grad_()
    every = meshctx.all_axes(mesh)
    p = tree_map(lambda v: meshctx.pvary(v, every), leaves)
    out = attention.apply_sequence_parallel(
        p, spec, x, q_block=case["q_block"], kv_block=case["kv_block"])
    loss = _loss(out, mesh)
    loss.backward()
    return {"out": out.detach(), "loss": loss.detach(), "x_grad": x.grad,
            **_grads(flat)}


def _moe(case, mesh):
    spec = moe.MoESpec(**case["spec"])
    gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(spec, mesh)
    m, n = mesh.coords["model"], meshctx.model_size(mesh)
    d, nd = mesh.index(meshctx.data_axes(mesh)), meshctx.data_size(mesh)
    leaves = {}
    for k, v in case["params"].items():
        t = torch.as_tensor(np.asarray(v))
        if k != "router":                  # E over model, FSDP over data
            t = t.chunk(n, 0)[m]
            if fsdp_ok:
                t = t.chunk(nd, down_ax if k == "w_down" else gate_ax)[d]
        leaves[k] = t.clone().requires_grad_()
    p = {k: (meshctx.pvary(v, meshctx.all_axes(mesh)) if k == "router"
             else v if fsdp_ok else meshctx.pvary(v, meshctx.data_axes(mesh)))
         for k, v in leaves.items()}
    x = block(case["x"], mesh).requires_grad_()
    out, aux = moe.apply(p, spec, x)
    loss = _loss(out, mesh) + aux
    loss.backward()
    return {"out": out.detach(), "aux": aux.detach(), "x_grad": x.grad,
            **{f"grad/{k}": v.grad for k, v in leaves.items()}}


def _swiglu(case, mesh):
    m, n = mesh.coords["model"], meshctx.model_size(mesh)
    full = {k: torch.as_tensor(np.asarray(v)) for k, v in
            case["params"].items()}
    d_ff = full["w_gate"].shape[-1]
    leaves = {k: (v.chunk(n, 0 if k == "w_down" else 1)[m]).clone()
              .requires_grad_() for k, v in full.items()}
    x = block(case["x"], mesh).requires_grad_()
    out = layers.swiglu(leaves, x, d_ff=d_ff)
    loss = _loss(out, mesh)
    loss.backward()
    return {"out": out.detach(), "x_grad": x.grad,
            **{f"grad/{k}": v.grad for k, v in leaves.items()}}


def _wkv(case, mesh):
    r, k, v, w = (block(case[n], mesh, seq=False) for n in "rkvw")
    state = block(case["state"], mesh, seq=False)
    y, s = rwkv._wkv_dispatch(r, k, v, w, torch.as_tensor(case["u"]), state)
    return {"y": y, "state": s}


def _model(case, mesh):
    from repro_torch import convert
    cfg = configs.get_config(case["arch"]).reduced().with_(
        **case.get("overrides", {}))
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    flat = {}
    params = _mark(sharding.local_params(full, mesh, cfg), flat)
    tokens = torch.as_tensor(np.asarray(case["tokens"])).long()
    batch = sharding.local_batch(
        {"tokens": tokens, "labels": torch.roll(tokens, -1, -1)}, mesh, cfg)
    loss = model.loss_fn(params, batch, cfg)
    loss.backward()
    return {"loss": loss.detach(), **_grads(flat)}


KINDS = {"attention": _attention, "moe": _moe, "swiglu": _swiglu,
         "wkv": _wkv, "model": _model}


def run_cases(rank: int, world: int, shape, axes, cases: dict):
    """{case id: this rank's result} for every case, each run twice."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(shape, axes)
    out = {}
    with meshctx.set_mesh(mesh):
        for cid, case in cases.items():
            first = KINDS[case["kind"]](case, mesh)
            again = KINDS[case["kind"]](case, mesh)
            res = tree_map(lambda t: t.detach().cpu(), first)
            res["repeat_equal"] = all(
                torch.equal(first[k], again[k]) for k in first)
            out[cid] = res
    out["coords"] = dict(mesh.coords)
    out["data_index"] = mesh.index(meshctx.data_axes(mesh))
    return out
