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

What a rank computes with is ``local_params``: the regions' layout (the
SwiGLU's F and the experts' E over ``model``, the experts' FSDP dim over
the data axes where the region gathers it, everything else whole);
storage-only FSDP belongs to the trainer (ROADMAP Queue 1 item 16.11).
``local_batch`` cuts a global batch to the rank's block.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib

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
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


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


# ---------------------------------------------------------------------------
# activations / batches / decode state

def train_batch_spec(mesh) -> tuple:
    ax = mesh_lib.data_axes(mesh)
    return (None, ax if len(ax) > 1 else ax[0])


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

def _block(t, dim: int, index: int, n: int):
    size = t.shape[dim]
    if size % n != 0:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    c = size // n
    return t.narrow(dim, index * c, c).contiguous()


def local_params(params, mesh, cfg: ModelConfig):
    """The rank's params in the regions' layout, from the full ``params``
    (every rank the same): the SwiGLU's F over ``model`` where the
    region takes it (d_ff % |model| == 0), the experts' E over ``model``
    and their FSDP dim (``moe.fsdp_layout``) over the data axes where it
    divides; every other leaf whole."""
    from repro_torch.models import blocks, moe
    model_n = mesh_lib.model_size(mesh)
    m_idx = mesh.coords["model"]
    daxes = mesh_lib.data_axes(mesh)
    d_idx, data_n = mesh.index(daxes), mesh_lib.data_size(mesh)
    if cfg.family == "moe":
        gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(blocks.moe_spec(cfg),
                                                    mesh)
    swiglu_tp = cfg.d_ff % model_n == 0

    def cut(path, leaf):
        names = _names(path)
        name = names[-1]
        skip = _STACK_DIMS.get(names[0], 0)
        if "moe" in names and name in ("w_gate", "w_up", "w_down"):
            leaf = _block(leaf, skip, m_idx, model_n)
            if fsdp_ok:
                ax = gate_ax if name != "w_down" else down_ax
                leaf = _block(leaf, skip + ax, d_idx, data_n)
            return leaf
        if "mlp" in names and swiglu_tp and name in ("w_gate", "w_up",
                                                     "w_down"):
            return _block(leaf, -1 if name != "w_down" else -2, m_idx,
                          model_n)
        return leaf

    return _map_with_path(cut, params)


def local_batch(batch, mesh, cfg: ModelConfig):
    """The rank's block of a global batch: rows over the data axes and,
    for the sequence-parallel families, columns over ``model``; RWKV6's
    (ssm) whole sequence on every model rank."""
    daxes = mesh_lib.data_axes(mesh)
    d_idx, data_n = mesh.index(daxes), mesh_lib.data_size(mesh)

    def cut(_, t):
        t = _block(t, 0, d_idx, data_n)
        if cfg.family != "ssm":
            t = _block(t, 1, mesh.coords["model"], mesh_lib.model_size(mesh))
        return t

    return _map_with_path(cut, batch)
