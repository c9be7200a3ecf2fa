"""Sharding rules: param / activation / state -> mesh partition specs (port
of ``repro.launch.sharding``).

The rules are the reference's, as pure functions of names and shapes; a
spec is a tuple with one entry a dim (None, an axis name, or a tuple of
axis names), the reference's ``PartitionSpec`` as a tuple, and the mesh
is anything with ``shape`` (axis -> size) and ``axis_names``.

* **Attention families:** sequence parallelism; the residual stream is
  T-sharded over ``model``, attention weights are compute-replicated over
  ``model`` and FSDP-sharded for storage; the SwiGLU's F over ``model``.
* **SSM families:** head-/channel-TP of the RWKV6 and Mamba2 projections.
* **MoE experts:** E -> model.  Router replicated.
* **Vocab:** embed/unembed V -> model.
* **Storage (FSDP):** the largest divisible dim over ``data``, or over
  (data x model) when 10 bytes a parameter would not fit 12 GB a rank on
  ``data`` alone.
* **Decode caches:** S -> model, batch -> data; recurrent states: a head
  or channel dim -> model.
* Stacked leading dims (layers, groups) are never sharded.

What a rank computes with is ``local_params``: the regions' layout
(``compute_spec``: the SwiGLU's F and the experts' E over ``model``, the
experts' FSDP dim over the data axes where the region gathers it,
everything else whole).  What the trainer stores is ``storage_params``:
``param_partition_spec``'s blocks, FSDP dim and all (``gather_params``
joins them back).  ``compute_params`` takes the storage blocks to the
compute layout: it all-gathers each leaf over every axis its storage
cuts and its compute layout does not.  ``storage_grads`` is its
transpose: each leaf's gradient summed once over the axes whose ranks
saw other tokens (``model._grad_sum_axes``) and reduce-scattered to the
storage blocks.  ``compute_plans`` says how, leaf by leaf.  The step
gathers once a step and reduce-scatters once a group.  ``local_batch`` cuts a
prefill's (B, T) batch to the rank's block, ``local_train_batch`` a
train step's (k, B/k, T): T over ``model`` for the dense, MoE and audio
families where the sequence is sequence-parallel, whole below the
threshold and for ssm, hybrid and vlm (``_seq_entry``); a serve
batch's rows the data axes do not divide stay whole on every data rank
(``serve_batch_spec``), a train batch's are refused.  ``local_rows``
cuts a serve batch's rows, ``local_decode_state`` a decode state
(``decode_state_specs``).
"""

from __future__ import annotations

import functools
import math
import types
from typing import NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import meshctx

_STACK_DIMS = {"layers": 1, "mamba": 2, "encoder": 1}

# families whose attention runs sequence-parallel (weights replicated)
SP_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid")


def _divides(dim_size: int, axis_size: int) -> bool:
    return axis_size > 0 and dim_size % axis_size == 0 \
        and dim_size >= axis_size


def storage_axes(cfg: ModelConfig | None, mesh) -> tuple:
    """FSDP storage axes: data, or data+model for very large models."""
    dd = mesh_lib.data_axes(mesh)
    if cfg is None:
        return dd
    footprint = cfg.param_count() * 10  # bf16 params + f32 adam m,v
    per_chip_data_only = footprint / mesh_lib.data_size(mesh)
    if per_chip_data_only > 12e9:
        return dd + ("model",)
    return dd


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
    return n


def _fsdp_entry(axes):
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _names(path) -> list:
    """A leaf's path as key names (strings, or JAX-style keys)."""
    return [str(getattr(k, "key", k)) for k in path]


def param_partition_spec(path, leaf, mesh, cfg: ModelConfig | None = None,
                         *, fsdp: bool = True,
                         min_fsdp_elems: int = 1 << 20) -> tuple:
    """The spec of the param at ``path`` (key names, outermost first) with
    ``leaf.shape``."""
    names = _names(path)
    top = names[0] if names else ""
    name = names[-1] if names else ""
    skip = _STACK_DIMS.get(top, 0)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    model_n = mesh.shape["model"] if "model" in mesh.axis_names else 0
    spec = [None] * ndim
    family = cfg.family if cfg is not None else None

    def assign(dim, axis, axis_size) -> bool:
        d = dim if dim >= 0 else ndim + dim
        if d < skip or d >= ndim or spec[d] is not None:
            return False
        if not _divides(shape[d], axis_size):
            return False
        spec[d] = axis
        return True

    in_moe = "moe" in names
    in_rwkv_tm = "time_mix" in names
    in_rwkv_cm = "channel_mix" in names
    in_mamba = top == "mamba"

    # ------------------------------------------------------------- model axis
    model_used = False
    if model_n:
        if in_moe:
            if name in ("w_gate", "w_up", "w_down"):
                model_used = assign(skip, "model", model_n)    # E -> model
        elif in_rwkv_tm:
            if name in ("wr", "wk", "wv", "wg", "wo", "w0", "u", "w_lora_b"):
                model_used = assign(-2, "model", model_n)      # H (H*hd)
            elif name in ("scale", "bias") and "ln_x" in names:
                model_used = assign(-1, "model", model_n)      # (H*hd,)
        elif in_rwkv_cm:
            if name == "wk":
                model_used = assign(-1, "model", model_n)      # F (col)
            elif name == "wv":
                model_used = assign(-2, "model", model_n)      # F (row)
        elif in_mamba and family == "hybrid":
            if name in ("w_z", "w_x", "conv_x", "A_log", "dt_bias", "D",
                        "w_dt"):
                model_used = assign(-1, "model", model_n)      # Din / H
            elif name == "w_out":
                model_used = assign(-2, "model", model_n)      # Din (row)
            elif name == "scale" and "norm" in names:
                model_used = assign(-1, "model", model_n)      # (Din,)
        elif name in ("embed", "unembed"):
            vocab_dim = -2 if name == "embed" else -1
            model_used = assign(vocab_dim, "model", model_n)   # V -> model
        elif name in ("w_gate", "w_up") and family in SP_FAMILIES:
            model_used = assign(-1, "model", model_n)          # F (col TP)
        elif name == "w_down" and family in SP_FAMILIES:
            model_used = assign(-2, "model", model_n)          # F (row TP)
        # SP families: attention weights stay model-replicated.

    # ------------------------------------------------------------ FSDP storage
    if fsdp and math.prod(shape) >= min_fsdp_elems and cfg is not None:
        axes = storage_axes(cfg, mesh)
        # don't stack model storage onto leaves already TP-sharded
        if model_used and "model" in axes:
            axes = tuple(a for a in axes if a != "model")
        if axes:
            n = _axes_size(mesh, axes)
            order = sorted(range(skip, ndim), key=lambda d: -shape[d])
            for d in order:
                if spec[d] is None and _divides(shape[d], n):
                    spec[d] = _fsdp_entry(axes)
                    break
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, named tuples, tuples and
    lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_specs(fn, tree, specs, path=()):
    """``fn(path, leaf, spec)`` over a tree of dicts (and the tuples of a
    decode state) beside its tree of specs (the spec tuples are its
    leaves)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        return type(tree)(map_specs(fn, v, sp, path + (i,))
                          for i, (v, sp) in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def _is_spec(t) -> bool:
    """Whether a tuple is a spec (entries None, an axis, or axes), not a
    subtree of leaves."""
    return all(e is None or isinstance(e, (str, tuple)) for e in t)


def spec_leaves(tree, specs) -> list:
    """The spec of every leaf of ``tree`` in ``tree_leaves`` order."""
    out = []
    map_specs(lambda _, __, s: out.append(tuple(s)), tree, specs)
    return out


def param_shardings(params, mesh, cfg: ModelConfig | None = None, *,
                    fsdp: bool = True):
    """``param_partition_spec`` of every leaf, as a tree of spec tuples."""
    return _map_with_path(lambda p, leaf: param_partition_spec(
        p, leaf, mesh, cfg, fsdp=fsdp), params)


def stacked_grad_shardings(params, mesh, cfg: ModelConfig | None = None, *,
                           fsdp: bool = True):
    """Specs of the (k, *param) stacked per-group gradients: the leading k
    dim replicated, the param dims in the param layout."""
    return _map_with_path(lambda p, leaf: (None,) + param_partition_spec(
        p, leaf, mesh, cfg, fsdp=fsdp), params)


def replicated(mesh) -> tuple:
    """The spec of a value every rank holds whole (``P()``)."""
    del mesh
    return ()


def gathered_grad_shardings(params, mesh):
    """Every stacked gradient replicated: the gathered variant, whose
    stacked gradients are gathered whole before the attack and the
    aggregation (the round kernel's input on the card)."""
    return _map_with_path(lambda _, __: replicated(mesh), params)


def opt_state_shardings(opt_state, params, mesh,
                        cfg: ModelConfig | None = None, *,
                        fsdp: bool = True):
    """The optimizer state's specs: a subtree shaped as ``params`` (AdamW's
    ``mu`` and ``nu``, SGD's momentum) takes the params' specs, every
    other leaf (the step count) is replicated.  (The reference looks a
    leaf's spec up by its shape, the first param of that shape deciding;
    where two params of one shape have different specs, RWKV6's
    ``channel_mix/wr`` and ``time_mix/wo``, it gives the second one's
    moments the first one's spec.  Here the moments keep their own
    param's, the layout the elementwise update needs.)"""
    pspecs = param_shardings(params, mesh, cfg, fsdp=fsdp)

    def same(a, b) -> bool:
        if isinstance(a, dict) or isinstance(b, dict):
            return isinstance(a, dict) and isinstance(b, dict) \
                and a.keys() == b.keys() and all(same(a[k], b[k])
                                                 for k in a)
        return True

    def walk(node):
        if isinstance(node, dict):
            if not same(node, params):
                raise ValueError("an optimizer-state dict that is not "
                                 "shaped as the params")
            return pspecs
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(v) for v in node])
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return replicated(mesh)

    return walk(opt_state)


# ---------------------------------------------------------------------------
# activations / batches / decode state

def train_batch_spec(mesh) -> tuple:
    ax = mesh_lib.data_axes(mesh)
    return (None, ax if len(ax) > 1 else ax[0])


def batch_shardings(batch, mesh):
    """A train batch's (k, B/k, ...) leaves: B/k over the data axes."""
    spec = train_batch_spec(mesh)
    return _map_with_path(
        lambda _, x: spec + (None,) * (len(x.shape) - 2), batch)


def serve_batch_spec(mesh, batch_size: int) -> tuple:
    ax = mesh_lib.data_axes(mesh)
    axes = ax if len(ax) > 1 else ax[0]
    if batch_size % mesh_lib.data_size(mesh) == 0:
        return (axes,)
    return (None,)


def decode_state_shardings(state, mesh, cfg: ModelConfig, batch_size: int):
    """KV caches (ndim 5: L, B, S, KV, hd): S -> model, B -> data.
    Recurrent and conv states: a head/channel dim -> model, B -> data."""
    bspec = serve_batch_spec(mesh, batch_size)
    b_axis = bspec[0] if len(bspec) > 0 else None
    model_n = mesh.shape["model"] if "model" in mesh.axis_names else 0

    def leaf(_, x):
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        b_dim = None
        for d in range(nd):
            if shape[d] == batch_size and b_axis is not None:
                spec[d] = b_axis
                b_dim = d
                break
        if model_n:
            if nd >= 5 and b_dim is not None and b_dim + 1 < nd \
                    and _divides(shape[b_dim + 1], model_n):
                # attention cache (..., B, S, KV, hd): shard S
                spec[b_dim + 1] = "model"
            else:
                # recurrent state: the first divisible feature dim after
                # batch (heads/channels)
                start = (b_dim + 1) if b_dim is not None else 0
                for d in range(start, nd):
                    if spec[d] is None and _divides(shape[d], model_n):
                        spec[d] = "model"
                        break
        return tuple(spec)

    return _map_with_path(leaf, state)


def grad_shard_spec(mesh, cfg: ModelConfig | None = None, *,
                    mode: str = "gspmd", target_backend: str | None = "cuda"):
    """The ``ShardSpec`` matching :func:`stacked_grad_shardings`: stacked
    gradients partitioned over the mesh ``model`` axis, ``round_backend``
    dispatch pinned to the mesh's target device type."""
    from repro_torch.core.shard_aggregation import ShardSpec
    model_n = mesh.shape["model"] if "model" in mesh.axis_names else 1
    return ShardSpec(num_shards=model_n, mode=mode, axis="model",
                     target_backend=target_backend)


# ---------------------------------------------------------------------------
# what a rank holds

def block_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axes_size(mesh, meshctx.entry_axes(entry)) if entry else 1
        if out[d] % n != 0:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {n}")
        out[d] //= n
    return tuple(out)


def cut_tree(tree, specs, mesh):
    """Every leaf of ``tree`` (whole, the same on every rank) cut to this
    rank's block of its spec."""
    return map_specs(lambda _, t, s: meshctx.cut(t, s, mesh.coords,
                                                 mesh.shape), tree, specs)


def gather_tree(tree, specs, mesh):
    """Every leaf of ``tree`` (this rank's blocks) gathered whole, in rank
    order: a tiled gather over each cut dim's axes, the leaves with the
    same gathers batched into one collective a bucket
    (``BUCKET_BYTES``)."""
    def plan(_, t, s):
        lead, ops = t.ndim - len(s), []
        for d, entry in enumerate(s):
            axes = meshctx.entry_axes(entry)
            if axes:
                if mesh.axes(axes) != axes:
                    raise ValueError(f"spec entry {entry!r} is not in the "
                                     f"mesh's axis order {mesh.axis_names}")
                ops.append(("gather", axes, lead + d, False))
        return LeafPlan(tuple(ops), ())

    return _map_many(tree, map_specs(plan, tree, specs), mesh,
                     transpose=False)


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: ModelConfig):
    """The params' shapes and dtypes, without their memory: ``model.init``
    traced under a fake-tensor mode (namespaces with ``shape`` and
    ``dtype``, which ``param_partition_spec`` reads)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model
    with FakeTensorMode():
        fake = model.init(0, cfg, device="cpu")
    return _map_with_path(lambda _, t: types.SimpleNamespace(
        shape=tuple(t.shape), dtype=t.dtype), fake)


def storage_params(params, mesh, cfg: ModelConfig, *, fsdp: bool = True):
    """The rank's storage blocks of the full ``params`` (every rank the
    same): ``param_partition_spec``'s layout, the reference's
    ``param_shardings``, FSDP dim and all."""
    return cut_tree(params, param_shardings(params, mesh, cfg, fsdp=fsdp),
                    mesh)


def gather_params(storage, mesh, cfg: ModelConfig, *, fsdp: bool = True):
    """The full params from every rank's storage blocks (the inverse of
    ``storage_params``), on every rank."""
    return gather_tree(storage, param_shardings(param_shapes(cfg), mesh, cfg,
                                                fsdp=fsdp), mesh)


def compute_spec(path, shape, mesh, cfg: ModelConfig, *,
                 expert_fsdp: bool = True) -> tuple:
    """The regions' layout of the param at ``path`` with the full
    ``shape``: the SwiGLU's F over ``model`` where d_ff % |model| == 0,
    the experts' E over ``model`` and their FSDP dim
    (``moe.fsdp_layout``) over the data axes where it divides (whole
    with ``expert_fsdp=False``, the serve layout: the region then
    gathers nothing a step), the Mamba2 blocks' channel-TP leaves
    (``mamba.TP_DIMS``, the gated norm's scale) over ``model`` where
    |model| divides the heads; every other leaf whole."""
    from repro_torch.models import blocks, mamba, moe
    names = _names(path)
    name = names[-1]
    skip = _STACK_DIMS.get(names[0], 0)
    spec = [None] * len(shape)
    if "moe" in names and name in ("w_gate", "w_up", "w_down"):
        gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(blocks.moe_spec(cfg),
                                                    mesh)
        spec[skip] = "model"
        if fsdp_ok and expert_fsdp:
            ax = gate_ax if name != "w_down" else down_ax
            spec[skip + ax] = _fsdp_entry(mesh_lib.data_axes(mesh))
    elif "mlp" in names and cfg.d_ff % mesh_lib.model_size(mesh) == 0 \
            and name in ("w_gate", "w_up", "w_down"):
        spec[-1 if name != "w_down" else -2] = "model"
    elif names[0] == "mamba" and mamba.tp_dim(names) is not None \
            and mamba.tp_applies(mesh, blocks.mamba_spec(cfg)):
        spec[mamba.tp_dim(names)] = "model"
    return tuple(spec)


def local_params(params, mesh, cfg: ModelConfig, *,
                 expert_fsdp: bool = True):
    """The rank's params in the regions' layout (``compute_spec``), from
    the full ``params`` (every rank the same); ``expert_fsdp=False`` for
    serving: the experts' FSDP dim whole."""
    return _map_with_path(lambda p, t: meshctx.cut(
        t, compute_spec(p, t.shape, mesh, cfg, expert_fsdp=expert_fsdp),
        mesh.coords, mesh.shape), params)


def _seq_entry(t, rows_dim: int, mesh, cfg: ModelConfig):
    """The axis a batch leaf's sequence dim (after its rows) is cut over:
    ``model`` for the families whose stream is cut as the batch is
    (``model.T_CUT_FAMILIES``: the dense and MoE tokens, the audio tokens
    and frames) where the leaf's own (rows, length) is sequence-parallel
    (``meshctx.sp_applicable``); below the threshold, and for ssm, hybrid
    and vlm, none: T whole on every model rank."""
    from repro_torch.models import model
    if cfg.family not in model.T_CUT_FAMILIES or t.ndim < rows_dim + 2:
        return None
    rows, seq = t.shape[rows_dim], t.shape[rows_dim + 1]
    return "model" if meshctx.sp_applicable(mesh, rows, seq) else None


def _cut_batch(batch, mesh, cfg: ModelConfig, rows_spec: tuple,
               rows_whole: bool = False):
    """The rank's ``meshctx.Block`` of ``batch``: each leaf's dims up to
    its rows by ``rows_spec``, its sequence dim after them by
    ``_seq_entry``, and the names of the leaves cut there recorded, and
    whether the rows are whole."""
    out, cut = {}, []
    for name, t in batch.items():
        seq = _seq_entry(t, len(rows_spec) - 1, mesh, cfg)
        spec = rows_spec + (seq,)
        out[name] = meshctx.cut(t, spec + (None,) * (t.ndim - len(spec)),
                                mesh.coords, mesh.shape)
        if seq is not None:
            cut.append(name)
    return meshctx.Block(out, cut, rows_whole)


def local_batch(batch, mesh, cfg: ModelConfig):
    """The rank's block of a global serve batch: rows by
    ``serve_batch_spec`` (over the data axes, or whole on every data rank
    where they do not divide them) and each sequence dim over
    ``_seq_entry`` (whole below the threshold and with whole rows: the
    block is (B/data, T) or (B, T)), a ``meshctx.Block`` that records
    which leaves it cut in T and whether its rows are whole, the layout
    the model reads."""
    whole = batch["tokens"].shape[0] % mesh_lib.data_size(mesh) != 0
    spec = (None,) if whole else (_fsdp_entry(mesh_lib.data_axes(mesh)),)
    return _cut_batch(batch, mesh, cfg, spec, rows_whole=whole)


def local_train_batch(batch, mesh, cfg: ModelConfig):
    """The rank's block of a train step's (k, B/k, T) batch: B/k over the
    data axes (``train_batch_spec``) and T over ``_seq_entry``, a
    ``meshctx.Block`` as ``local_batch``'s.  Rows the data axes do not
    divide are refused: the reference's ``train_batch_spec`` always cuts
    them."""
    rows = batch["tokens"].shape[1]
    if rows % mesh_lib.data_size(mesh) != 0:
        raise NotImplementedError(
            f"a train batch of {rows} rows a group on "
            f"{mesh_lib.data_size(mesh)} data ranks: the reference's "
            "train_batch_spec cuts a train batch's rows over the data axes, "
            "so they must divide them")
    return _cut_batch(batch, mesh, cfg, train_batch_spec(mesh))


def local_rows(t, mesh):
    """The rank's rows of a serve batch's (B, ...) leaf
    (``serve_batch_spec``: over the data axes, or all of them where the
    data axes do not divide B)."""
    return meshctx.cut(t, serve_batch_spec(mesh, t.shape[0])
                       + (None,) * (t.ndim - 1), mesh.coords, mesh.shape)


def _decode_dims(path, ndim: int) -> tuple[int, int]:
    """(the batch dim, the dim cut over ``model``) of a decode state's
    leaf, the layout the port's decode takes: the KV caches' slots (L or
    groups, B, S, KV, hd), the audio memory's S (B, S, D), RWKV6's token
    shifts' D (L, B, D) and WKV heads (L, B, H, hd, hd), Zamba2's conv
    channels (groups, per, B, K-1, C) and SSM heads (groups, per, B, H,
    P, N)."""
    top = path[0]
    if top in ("cache", "attn"):
        return ndim - 4, ndim - 3
    if top == "memory":
        return 0, 1
    if top == "states":
        return 1, 2
    if top == "conv":
        return ndim - 3, ndim - 1
    if top == "ssm":
        return ndim - 4, ndim - 3
    raise ValueError(f"no decode state leaf at {path}")


def decode_state_specs(state, mesh, cfg: ModelConfig, batch: int):
    """The specs ``local_decode_state`` cuts a decode state (for ``batch``
    rows) by, the layout the port's mesh decode takes: the batch dim and
    the dim ``_decode_dims`` names over ``model``.  Where the data axes
    divide the rows these are the reference's ``decode_state_shardings``,
    rows over the data axes; a state its rules cut otherwise (a cache
    whose slots |model| does not divide, Mamba2 heads it does not divide)
    is refused.  Where they do not divide them the rows are whole on
    every data rank (``serve_batch_spec``'s ``(None,)``) and the same dim
    is cut over ``model``, refused where |model| does not divide it: the
    reference's rule, finding no batch dim there, puts ``model`` on the
    first dim it divides (a KV cache's layers, Zamba2's blocks of a
    group), a storage layout for GSPMD to gather from, which the port's
    decode does not hold."""
    specs = decode_state_shardings(state, mesh, cfg, batch)
    b_axis = serve_batch_spec(mesh, batch)[0]
    model_n = _axes_size(mesh, "model") if "model" in mesh.axis_names else 1

    def cuts(spec):
        """The entries that cut: over axes of more than one rank."""
        return tuple(e if e and _axes_size(mesh, meshctx.entry_axes(e)) > 1
                     else None for e in spec)

    def check(path, t, spec):
        b, m = _decode_dims(path, t.ndim)
        want = [None] * t.ndim
        want[b], want[m] = b_axis, "model"
        if b_axis is None:
            ok = _divides(t.shape[m], model_n)
            spec = tuple(want)
        else:
            ok = cuts(spec) == cuts(want)
        if not ok:
            raise NotImplementedError(
                f"decode state {'/'.join(map(str, path))} "
                f"{tuple(t.shape)} cut as {spec} under the mesh "
                f"{mesh.shape}: the mesh decode takes {tuple(want)} with "
                f"dim {m} over model (other layouts: ROADMAP Queue 1 item "
                "16.17)")
        return tuple(spec)

    return map_specs(check, state, specs)


def local_decode_state(state, mesh, cfg: ModelConfig, batch: int):
    """The rank's block of a decode state (``model.init_decode_state``'s,
    for ``batch`` rows), cut by ``decode_state_specs`` through
    ``meshctx.cut``; ``gather_tree`` with the same specs joins it back."""
    specs = decode_state_specs(state, mesh, cfg, batch)
    return map_specs(lambda _, t, s: meshctx.cut(t, s, mesh.coords,
                                                 mesh.shape), state, specs)


# ---------------------------------------------------------------------------
# storage to compute and back

class LeafPlan(NamedTuple):
    """How one leaf goes from its storage block to its compute block:
    ``ops`` in order, each ("gather", axes, dim, summed) or ("slice",
    axes, dim), and ``rest``, the axes its gradient is summed over beyond
    the gathers' transposes.  A gather's transpose is a reduce-scatter
    where the gradient is summed over its axes (``summed``), else the
    rank's slice: a region already summed it there."""
    ops: tuple
    rest: tuple


def _leaf_plan(sspec, cspec, sum_axes, mesh) -> LeafPlan:
    ops, summed = [], set()
    for d, (se, ce) in enumerate(zip(sspec, cspec)):
        s_ax, c_ax = meshctx.entry_axes(se), meshctx.entry_axes(ce)
        if s_ax == c_ax:
            continue
        if s_ax:
            hit = set(s_ax) & set(sum_axes)
            if hit and hit != set(s_ax):
                raise NotImplementedError(
                    f"a storage dim over {s_ax} of which only "
                    f"{sorted(hit)} sum the gradient")
            ops.append(("gather", mesh.axes(s_ax), d, bool(hit)))
            summed |= hit
        if c_ax:
            if set(c_ax) & set(sum_axes):
                raise ValueError(f"a compute layout cut over {c_ax} whose "
                                 "gradient is summed over them")
            ops.append(("slice", mesh.axes(c_ax), d))
    rest = tuple(a for a in mesh.axis_names
                 if a in sum_axes and a not in summed)
    return LeafPlan(tuple(ops), rest)


def compute_plans(storage, specs, mesh, cfg: ModelConfig, *, batch: int,
                  seq: int):
    """The ``LeafPlan`` of every storage leaf (``specs`` its storage
    specs) for a group of global (``batch``, ``seq``) tokens."""
    from repro_torch.models import model

    def plan(path, t, s):
        whole = meshctx.whole_shape(tuple(t.shape), s, mesh.shape)
        return _leaf_plan(s, compute_spec(path, whole, mesh, cfg),
                          set(model._grad_sum_axes(path, cfg, mesh, batch,
                                                   seq)), mesh)

    return map_specs(plan, storage, specs)


def _narrow(t, axes, dim, mesh):
    spec = [None] * t.ndim
    spec[dim] = axes
    return meshctx.cut(t, tuple(spec), mesh.coords, mesh.shape)


# the bytes of one batched collective, at most (a leaf above it alone)
BUCKET_BYTES = 1 << 28


def _buckets(ts, plans):
    """Index lists of leaves whose plans make the same collectives (the
    dims aside), each list at most ``BUCKET_BYTES`` but for one leaf."""
    groups = {}
    for i, p in enumerate(plans):
        sig = (tuple(op[:2] + op[3:] for op in p.ops), p.rest)
        groups.setdefault(sig, []).append(i)
    for idx in groups.values():
        bucket, size = [], 0
        for i in idx:
            nb = ts[i].numel() * ts[i].element_size()
            if bucket and size + nb > BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
            bucket.append(i)
            size += nb
        yield bucket


def _many(ts, plans, mesh, transpose: bool) -> list:
    """Every storage block taken to its compute block by its plan (or,
    ``transpose``, every compute gradient to its storage block), the
    leaves with the same collectives batched into one call a bucket."""
    out = list(ts)
    for idx in _buckets(ts, plans):
        xs = [ts[i] for i in idx]
        ops = plans[idx[0]].ops
        order = range(len(ops) - 1, -1, -1) if transpose else range(len(ops))
        for j in order:
            kind, axes = ops[j][:2]
            dims = [plans[i].ops[j][2] for i in idx]
            if kind == "gather" and not transpose or kind == "slice" \
                    and transpose:
                xs = meshctx._all_gather_many(xs, mesh, axes, dims)
            elif kind == "gather" and ops[j][3]:
                xs = meshctx._psum_scatter_many(xs, mesh, axes, dims)
            else:
                xs = [_narrow(x, axes, d, mesh) for x, d in zip(xs, dims)]
        if transpose and plans[idx[0]].rest:
            xs = meshctx._psum_many(xs, mesh, plans[idx[0]].rest)
        for i, x in zip(idx, xs):
            out[i] = x
    return out


def _map_many(tree, plans, mesh, transpose: bool):
    ts, ps = [], []
    map_specs(lambda _, t, p: (ts.append(t), ps.append(p)), tree, plans)
    it = iter(_many(ts, ps, mesh, transpose))
    return map_specs(lambda *_: next(it), tree, plans)


def compute_params(storage, plans, mesh):
    """The compute layout from the storage blocks (no autograd): the
    step's one gather a step, batched (``BUCKET_BYTES``)."""
    return _map_many(storage, plans, mesh, transpose=False)


def storage_grads(grads, plans, mesh):
    """The compute layout's gradients (this rank's partials, as model code
    returns them under ``meshctx.param_sums_deferred``) summed and
    reduce-scattered to the storage blocks, batched (``BUCKET_BYTES``)."""
    return _map_many(grads, plans, mesh, transpose=True)
