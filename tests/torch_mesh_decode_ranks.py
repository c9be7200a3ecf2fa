"""Rank bodies of the mesh decode and short-prefill tests
(tests/test_torch_mesh_decode.py).

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  ``run_cases`` builds
a (2, 2) and a (1, 4) ("data", "model") mesh over the same 4 ranks and
runs each case under the mesh it names; a case is a dict with ``kind``:

* ``"decode"``: the reduced ``arch`` (the config fields in
  ``overrides``) from the whole ``params`` (numpy) cut to the compute
  layout, a decode state of ``max_len`` for the rows of ``tokens`` (B,
  S) (numpy; the audio family's ``memory`` (B, S_enc, D) put in it) cut
  to the rank's block (``sharding.local_decode_state``), then S steps of
  ``steps.make_serve_step``, token t at position t: the logits of every
  step for the rank's rows (B/data, S, V; all B rows where the data axes
  do not divide B), and the state's blocks gathered whole (rank 0 only);
  ``fault`` plants one: ``"no_rescale"``
  sums the ranks' softmax parts without rescaling them by the global
  max, ``"no_gather"`` hands the rank's Mamba2 B and C conv block to its
  heads as if it were every channel (no gather);
* ``"prefill"``: ``steps.make_prefill_step`` on the rank's block of
  ``batch`` (numpy; ``sharding.local_batch``, which records the
  layout), and ``model.loss_fn`` with its gradients gathered whole (rank
  0 only), but for rows the data axes do not divide, which serve only;
* ``"train"``: one step of ``steps.make_group_train_step`` (the
  gathered variant, the ``rc`` aggregation, SGD at ``lr``) on the rank's
  ``sharding.local_train_batch`` block of ``batch`` (numpy, (k, B/k,
  T)): its metrics and the params after it gathered whole (rank 0
  only);
* ``"generate"``: ``serve.generate`` of ``new_tokens`` from the rank's
  rows of ``prompts`` (numpy) on the serve layout
  (``local_params(expert_fsdp=False)``): its rows' tokens.

A result is a dict of CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

import dataclasses

from repro_torch import configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import robust_train as rt
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, sharding, steps
from repro_torch.models import mamba, meshctx, model

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def cfg_of(case):
    return configs.get_config(case["arch"]).reduced().with_(
        **case.get("overrides", {}))


def as_batch(tree):
    """A numpy batch as tensors: integer leaves as int64."""
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).long()
                    if np.issubdtype(np.asarray(a).dtype, np.integer)
                    else torch.as_tensor(np.asarray(a)), tree)


def decode_state(cfg, case):
    """The case's global decode state (zeros; the audio memory its
    ``memory``)."""
    state = model.init_decode_state(cfg, case["tokens"].shape[0],
                                    case["max_len"], device="cpu")
    if "memory" in case:
        state["memory"] = torch.as_tensor(case["memory"])
    return state


def decode_logits(cfg, params, state, tokens):
    """Teacher-forced decode: token t at position t, every step's logits
    (B, S, V)."""
    step = steps.make_serve_step(cfg)
    out = []
    for t in range(tokens.shape[1]):
        pos = torch.full((tokens.shape[0],), t, dtype=torch.int64)
        logits, state = step(params, state, tokens[:, t:t + 1], pos)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def _no_rescale(m, l, o, axes, *, mesh=None):
    """The planted fault: the ranks' parts summed as they are, each
    normalised by its own max."""
    parts = meshctx._parts(torch.cat([l[..., None], o], -1), mesh,
                           mesh.axes(axes))
    total = meshctx._chain(parts)
    return total[..., 1:] / total[..., :1]


def _no_gather(b_blk, c_blk, mesh):
    """The planted fault: the rank's B and C block tiled over every
    channel in place of the gather."""
    n = meshctx.model_size(mesh)
    return b_blk.repeat(1, 1, n), c_blk.repeat(1, 1, n)


FAULTS = {"no_rescale": (meshctx, "softmax_combine", _no_rescale),
          "no_gather": (mamba, "_gather_channels", _no_gather)}


def _decode(case, mesh):
    cfg = cfg_of(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    local = sharding.local_params(full, mesh, cfg)
    rows = case["tokens"].shape[0]
    whole = decode_state(cfg, case)
    specs = sharding.decode_state_specs(whole, mesh, cfg, rows)
    state = sharding.local_decode_state(whole, mesh, cfg, rows)
    tokens = sharding.local_rows(torch.as_tensor(case["tokens"]).long(),
                                 mesh)
    fault = FAULTS.get(case.get("fault"))
    if fault is not None:
        real = getattr(fault[0], fault[1])
        setattr(fault[0], fault[1], fault[2])
    try:
        logits = decode_logits(cfg, local, state, tokens)
    finally:
        if fault is not None:
            setattr(fault[0], fault[1], real)
    out = {"logits": logits}
    gathered = sharding.gather_tree(state, specs, mesh)
    if mesh.rank == 0:
        out["state"] = gathered
    return out


def _prefill(case, mesh):
    cfg = cfg_of(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    specs = sharding._map_with_path(
        lambda p, t: sharding.compute_spec(p, tuple(t.shape), mesh, cfg),
        full)
    local = sharding.cut_tree(full, specs, mesh)
    batch = sharding.local_batch(as_batch(case["batch"]), mesh, cfg)
    h = steps.make_prefill_step(cfg)(local, batch)
    if batch.rows_whole:
        return {"h": h}                   # whole rows serve, never train
    local = tree_map(lambda t: t.detach().clone().requires_grad_(), local)
    loss = model.loss_fn(local, batch, cfg)
    loss.backward()
    grads = sharding.gather_tree(tree_map(lambda t: t.grad, local), specs,
                                 mesh)
    out = {"h": h, "loss": loss.detach()}
    if mesh.rank == 0:
        out["grads"] = grads
    return out


def train_step(case, mesh=None):
    """One group train step of ``case`` from its whole params: on
    ``mesh`` (the gathered variant, the batch the rank's block), or in
    one process -> (metrics, the params after the step, whole)."""
    cfg = cfg_of(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    rc = rt.RobustConfig(**case["rc"])
    opt = optim.sgd(case["lr"])
    batch = as_batch(case["batch"])
    kw, specs = {}, None
    if mesh is not None:
        specs = sharding.param_shardings(full, mesh, cfg)
        full = sharding.cut_tree(full, specs, mesh)
        kw = dict(grad_shardings=sharding.gathered_grad_shardings(full, mesh),
                  shard_spec=dataclasses.replace(sharding.grad_shard_spec(
                      mesh, cfg, target_backend="cpu"), num_shards=1),
                  param_shardings=specs)
        batch = sharding.local_train_batch(batch, mesh, cfg)
    step = steps.make_group_train_step(cfg, rc, opt, **kw)
    params, _, metrics = step(full, opt.init(full), batch,
                              prng.PRNGKey(case["seed"]), 0)
    if mesh is not None:
        params = sharding.gather_tree(params, specs, mesh)
    return metrics, params


def _train(case, mesh):
    metrics, params = train_step(case, mesh)
    out = {"metrics": metrics}
    if mesh.rank == 0:
        out["params"] = params
    return out


def _generate(case, mesh):
    cfg = cfg_of(case)
    full = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
    local = sharding.local_params(full, mesh, cfg, expert_fsdp=False)
    whole = torch.as_tensor(case["prompts"]).long()
    tokens, _, _ = serve.generate(local, cfg,
                                  sharding.local_rows(whole, mesh),
                                  case["new_tokens"], batch=whole.shape[0])
    return {"tokens": tokens}


KINDS = {"decode": _decode, "prefill": _prefill, "train": _train,
         "generate": _generate}


def run_cases(rank: int, world: int, cases: dict):
    """{case id: this rank's result}."""
    torch.set_num_threads(1)
    meshes = {name: mesh_lib.make_mesh(shape, axes)
              for name, (shape, axes) in MESHES.items()}
    out = {}
    for cid, case in cases.items():
        mesh = meshes[case["mesh"]]
        with meshctx.set_mesh(mesh):
            out[cid] = KINDS[case["kind"]](case, mesh)
    return out
