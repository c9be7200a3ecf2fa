"""Mixture-of-Experts layer: top-k router, capacity-bounded dispatch
(port of ``repro.models.moe``).

Each token picks its ``experts_per_token`` (K) experts from the softmax
of a float32 router (top-k on the probabilities, weights renormalised
over the K).  An expert takes at most C = ``_capacity`` tokens: the
(token, k) assignments are ranked within their expert by a stable sort,
so the earlier token wins a slot, and an assignment past C is dropped
(its weight is 0).  The router adds the Switch load-balance loss and the
z-loss.

The reference scatters into the (E, C, D) expert buffers and scatter-adds
the K outputs of a token; here the data moves through gathers only, each
one's backward an accumulation into rows no two live entries share:

* dispatch gathers each filled slot's row from the token rows repeated K
  times (``x_rep``); an empty slot reads row 0 through a ``where``, so
  its gradient adds exact zeros;
* the combine gathers each assignment's expert output (a dropped one
  reads slot (0, C-1) with weight 0), reshapes to (N, K, D) and sums over
  K in float32.

So no float sum depends on the order in which threads or atomics land,
and the layer batches under ``torch.func.vmap`` (out-of-place ops only).
Ties in the router's probabilities are broken as the reference's
``lax.top_k`` breaks them, towards the lower expert id (a stable
descending sort).

The expert products are batched matmuls over E, as the reference's
``vmap`` of einsums; no Pallas kernel computes them there.  Under a model
mesh (``meshctx.set_mesh``) ``apply`` runs expert parallelism
(``_apply_expert_parallel``, the reference's shard_map body on the
rank's block): E/|model| experts a rank, each rank routing its data
shard's tokens to its own experts in a capacity buffer of that shard.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers, meshctx


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int                  # per-expert hidden size
    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4


def init(gen, spec: MoESpec, *, dtype, stack: tuple = ()):
    """The router (float32 whatever ``dtype``) and the experts' SwiGLU
    weights (*stack, E, d_in, d_out), each drawn as one leaf."""
    E, D, F_ = spec.num_experts, spec.d_model, spec.d_ff

    def experts(d_in, d_out):
        return layers.truncated_normal_init(gen, (*stack, E, d_in, d_out),
                                            d_in ** -0.5, dtype)

    return {
        "router": layers.dense_init(gen, D, E, dtype=torch.float32,
                                    stack=stack),
        "w_gate": experts(D, F_),
        "w_up": experts(D, F_),
        "w_down": experts(F_, D),
    }


def _capacity(spec: MoESpec, num_tokens: int) -> int:
    cap = int(spec.capacity_factor * num_tokens
              * spec.experts_per_token / spec.num_experts)
    return max(cap, spec.experts_per_token)


def _counts(ids, num_buckets: int):
    """(num_buckets,) int64: how many entries of the flat ``ids`` fall in
    each bucket (a one-hot sum, which batches under vmap)."""
    buckets = torch.arange(num_buckets, device=ids.device)
    return (ids[:, None] == buckets).sum(0)


def route(params, spec: MoESpec, x_flat):
    """Router: top-k ids and weights, and the aux losses.  x_flat (N, D)
    -> (top_ids (N, K) int64, top_w (N, K) f32, aux, z)."""
    logits = x_flat.to(torch.float32) @ params["router"]        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = spec.experts_per_token
    top_w, top_ids = top_w[:, :K], top_ids[:, :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = _counts(top_ids.reshape(-1), spec.num_experts).to(torch.float32) \
        / top_ids.numel()
    p = probs.mean(0)
    aux = spec.num_experts * torch.sum(f * p)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return top_ids, top_w, aux, z


def _ranks(flat_ids, num_buckets: int):
    """Rank of each assignment within its bucket, earlier first.
    -> (order, the stable sort of ``flat_ids``; counts and first
    position of each bucket in it; slots, each assignment's rank)."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = _counts(flat_ids, num_buckets)
    first = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=flat_ids.device) \
        - first[flat_ids[order]]
    slots = torch.zeros_like(rank_sorted).scatter(0, order, rank_sorted)
    return order, counts, first, slots


def _dispatch_local(spec: MoESpec, x_flat, top_ids, top_w, *,
                    expert_lo: int, num_local: int, capacity: int):
    """Capacity-bounded dispatch of local tokens to the experts
    [expert_lo, expert_lo + num_local).  -> (expert_in (E_loc, C, D),
    (token_idx, safe_e, safe_s, w)): per assignment its token, its
    expert and slot ((0, C-1) when dropped) and its weight (0 when
    dropped), as the reference returns them."""
    N, D = x_flat.shape
    K = spec.experts_per_token
    dev = x_flat.device
    flat_ids = top_ids.reshape(-1)
    local = (flat_ids >= expert_lo) & (flat_ids < expert_lo + num_local)
    le = torch.where(local, flat_ids - expert_lo, num_local)   # sentinel
    order, counts, first, slots = _ranks(le, num_local + 1)
    keep = local & (slots < capacity)
    token_idx = torch.arange(N, device=dev).repeat_interleave(K)
    safe_e = torch.where(keep, le, 0)
    safe_s = torch.where(keep, slots, capacity - 1)

    # slot s of expert e holds the assignment at first[e] + s of the
    # sorted order, when the expert has more than s assignments
    s = torch.arange(capacity, device=dev)
    filled = s < counts[:num_local, None]                      # (E_loc, C)
    pos = torch.clamp(first[:num_local, None] + s, max=N * K - 1)
    src = torch.where(filled, order[pos], 0)
    x_rep = x_flat[:, None, :].expand(N, K, D).reshape(N * K, D)
    expert_in = torch.where(filled[..., None], x_rep[src], 0)
    w = torch.where(keep, top_w.reshape(-1), 0.0)
    return expert_in, (token_idx, safe_e, safe_s, w)


def _expert_ffn(w_gate, w_up, w_down, h):
    """Every expert's SwiGLU on its slots: h (E, C, D) -> (E, C, D)."""
    g = h @ w_gate
    u = h @ w_up
    act = F.silu(g.to(torch.float32)).to(h.dtype) * u
    return act @ w_down


def _combine(expert_out, info, num_tokens: int):
    """Each token's K expert outputs, weighted and summed in float32 ->
    (N, D) f32.  The assignments are token-major (token_idx is each
    token repeated K times), so the sum is a reshape and a sum over K."""
    _, safe_e, safe_s, w = info
    E, C, D = expert_out.shape
    gathered = expert_out.reshape(E * C, D)[safe_e * C + safe_s]
    weighted = gathered.to(torch.float32) * w[:, None]
    return weighted.reshape(num_tokens, -1, D).sum(1)


def _ep_applicable(spec: MoESpec, x, mesh) -> bool:
    """The reference's test.  ``x`` is the rank's block, so the batch
    divides the data axes by construction."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    if not meshctx.data_axes(mesh):
        return False
    model_n = mesh.shape["model"]
    return spec.num_experts % model_n == 0 and spec.num_experts >= model_n


def fsdp_layout(spec: MoESpec, mesh):
    """(gate_fsdp_axis, down_fsdp_axis, fsdp_ok): the expert weights'
    FSDP dim over the data axes, as the reference's region gathers it
    (the larger of D and F; (E, D, F) and (E, F, D) layouts)."""
    D_, F_ = spec.d_model, spec.d_ff
    data_n = meshctx.data_size(mesh)
    return (1 if D_ >= F_ else 2, 2 if D_ >= F_ else 1,
            max(D_, F_) % data_n == 0 and max(D_, F_) >= data_n)


def apply(params, spec: MoESpec, x, *, aux: bool = True):
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar).  Under a model
    mesh where ``_ep_applicable`` holds, x is the rank's stream and the
    expert-parallel region runs on the rank's experts
    (``_apply_expert_parallel``); else the dense path.  ``aux=False``
    (decode, which discards the aux loss): the region makes none of its
    statistics' collectives and returns 0.0 (the reference's compiled
    decode drops them as dead code)."""
    mesh = meshctx.current_mesh()
    if _ep_applicable(spec, x, mesh):
        return _apply_expert_parallel(params, spec, x, mesh, aux=aux)
    return _apply_dense(params, spec, x)


def fsdp_cut(spec: MoESpec, leaf, name: str, mesh) -> bool:
    """Whether an expert leaf (..., E/model, ., .) of the rank holds its
    FSDP dim cut over the data axes (the compute layout), not whole (the
    serve layout, ``launch.sharding.local_params(expert_fsdp=False)``)."""
    gate_ax, down_ax, fsdp_ok = fsdp_layout(spec, mesh)
    ax = down_ax if name == "w_down" else gate_ax
    return fsdp_ok and leaf.shape[ax - 3] != max(spec.d_model, spec.d_ff)


def _apply_expert_parallel(params, spec: MoESpec, x, mesh, *,
                           aux: bool = True):
    """Expert parallelism on one rank (the reference's shard_map body).

    ``x`` is (B/data, T/model, D), the rank's block of a sequence-parallel
    stream, or, where the stream is not cut over ``model``
    (``meshctx.stream_is_cut``: decode, and prefill below the threshold),
    the data shard's rows (B/data, T, D), the same on every model rank,
    or the whole batch's (B, T, D) on every rank where the data axes do
    not divide B (the reference routes those densely: here the buffer's
    capacity comes from the same B x T tokens, so the same assignments
    are kept, and the statistics' psum over the data axes counts every
    data rank's copy in the sums and in their token count alike).
    ``params``: the router whole; the experts the rank's E/|model|
    (E/model, D, F) slices, their FSDP dim (``fsdp_layout``) further
    split over the data axes when it divides (``fsdp_cut``: whole in the
    serve layout).  The region gathers a cut FSDP dim of the expert
    weights over data, gathers a cut x over ``model``, routes the
    data shard's B/data x T tokens to its experts in a capacity buffer of
    that shard (C from B/data x T tokens), and sums the partial outputs
    over ``model``: one psum_scatter back to a cut block, or a psum that
    each rank keeps as its own copy (``pvary(psum(.))``, the copies'
    cotangents summed in its backward).  Every model rank routed the same
    tokens either way, so the router's statistics are psum'd (in one
    collective) over the data axes and ``model`` and divided by |model|:
    aux and z are the global
    ones, and each copy's share of their gradient is 1/|model| (the
    reference's uncut branch psums them over the data axes alone, the
    same values).  The top-k comes from ``route``, so a replacement of it
    steers this path too."""
    B_loc, t_blk, D = x.shape
    E, K = spec.num_experts, spec.experts_per_token
    model_n = mesh.shape["model"]
    data_axes = meshctx.data_axes(mesh)
    data_n = meshctx.data_size(mesh)
    e_loc = E // model_n
    t_sharded = meshctx.stream_is_cut()
    T = t_blk * model_n if t_sharded else t_blk
    n_loc = B_loc * T
    cap = max(int(spec.capacity_factor * n_loc * K / E), K)
    gate_ax, down_ax, _ = fsdp_layout(spec, mesh)

    w_gate, w_up, w_down = params["w_gate"], params["w_up"], \
        params["w_down"]
    if fsdp_cut(spec, w_gate, "w_gate", mesh):
        w_gate = meshctx.all_gather(w_gate, data_axes, gate_ax, mesh=mesh)
        w_up = meshctx.all_gather(w_up, data_axes, gate_ax, mesh=mesh)
        w_down = meshctx.all_gather(w_down, data_axes, down_ax, mesh=mesh)
    if t_sharded:
        x = meshctx.all_gather(x, "model", 1, mesh=mesh)
    x_flat = x.reshape(n_loc, D)
    top_ids, top_w, _, _ = route(params, spec, x_flat)
    logits = x_flat.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)

    expert_lo = mesh.coords["model"] * e_loc
    expert_in, info = _dispatch_local(spec, x_flat, top_ids, top_w,
                                      expert_lo=expert_lo, num_local=e_loc,
                                      capacity=cap)
    expert_out = _expert_ffn(w_gate, w_up, w_down, expert_in)
    out_flat = _combine(expert_out, info, n_loc)
    # the experts' contributions summed over the model axis, scattered
    # back to a cut block, or kept whole as this rank's copy
    out = out_flat.reshape(B_loc, T, D)
    if t_sharded:
        out = meshctx.psum_scatter(out, "model", 1, mesh=mesh)
    else:
        out = meshctx.pvary(meshctx.psum(out, "model", mesh=mesh), "model",
                            mesh=mesh)

    if not aux:
        return out.to(x.dtype), 0.0
    # the global router statistics for the aux losses, in one collective
    stat_axes = data_axes + ("model",)
    stat_norm = model_n
    counts = _counts(top_ids.reshape(-1), E).to(torch.float32)
    z_sum = torch.sum(torch.square(torch.logsumexp(logits, -1)))
    stats = meshctx.psum(torch.cat([counts, probs.sum(0), z_sum[None]]),
                         stat_axes, mesh=mesh) / stat_norm
    counts, p_sum, z_sum = stats[:E], stats[E:2 * E], stats[2 * E]
    n_tot = n_loc * data_n
    f = counts / (n_tot * K)
    p = p_sum / n_tot
    aux_loss = E * torch.sum(f * p)
    z = z_sum / n_tot
    return (out.to(x.dtype),
            spec.router_aux_weight * aux_loss + spec.router_z_weight * z)


def _apply_dense(params, spec: MoESpec, x):
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar)."""
    B, T, D = x.shape
    N = B * T
    C = _capacity(spec, N)
    x_flat = x.reshape(N, D)
    top_ids, top_w, aux, z = route(params, spec, x_flat)
    expert_in, info = _dispatch_local(spec, x_flat, top_ids, top_w,
                                      expert_lo=0,
                                      num_local=spec.num_experts,
                                      capacity=C)
    expert_out = _expert_ffn(params["w_gate"], params["w_up"],
                             params["w_down"], expert_in)
    out = _combine(expert_out, info, N).to(x.dtype).reshape(B, T, D)
    aux_total = spec.router_aux_weight * aux + spec.router_z_weight * z
    return out, aux_total
