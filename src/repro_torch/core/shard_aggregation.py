"""Shard-local robust aggregation: the ZeRO-1 contract for every rule
(PyTorch port of ``repro.core.shard_aggregation``).

The stacked gradients stay partitioned over parameter shards and every
registered rule runs on per-shard slices:

* **coordinate-wise rules** touch each coordinate on its own and need no
  collective at all;
* **norm-based rules** need only small cross-shard reductions: per-shard
  partial squared norms combined into the (k,) distance or norm vector
  (one per Weiszfeld iterate for GMoM), and one (m, m) partial gram for
  krum.

:class:`ShardSpec` says how the stacked gradients are partitioned and
which mode combines the partials:

* ``"gspmd"``     — dispatch metadata only: the reductions stay plain
  torch reductions; a partitioned spec still forces the ``reference``
  round backend, and ``target_backend`` names the device type
  (``"cuda"``/``"cpu"``) that auto-dispatch keys off.
* ``"shard_map"`` — code running on one rank of a ``torch.distributed``
  group that holds its slice: per-shard partials are all-gathered in rank
  order and combined by an unrolled, ordered sum.  ``ShardSpec.axis`` names
  the group: the ambient model mesh's (``models.meshctx.set_mesh``) where
  it has the axis, else the one bound by :func:`axis_group`; an unbound
  axis is the default (WORLD) group.  The mesh holds the one registry of
  axis groups (``models.meshctx.axis_group_of``).
* ``"virtual"``   — the single-process oracle of ``"shard_map"``: the
  leaves are whole, but every reduction is taken as per-shard partials of
  contiguous slices, stacked shard-major, then the same ordered sum.  Each
  slice partial runs the same ops on the same values and layout as the
  rank holding that slice, so the two modes give the same bits.

Partitioning convention (both blocked modes): a stacked leaf with at least
one parameter dim (``ndim > lead_axes``) is split on its LAST dim, which
must divide by ``num_shards``; a leaf with no parameter dims (a stacked
scalar, shape ``(m,)``) is replicated and its partial belongs to shard 0.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models import meshctx

_MODES = ("gspmd", "shard_map", "virtual")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How the stacked gradient pytree is partitioned over param shards.

    * ``num_shards``     — shard count along the partitioned (last) dim;
                           1 means not partitioned.
    * ``mode``           — ``"gspmd"`` / ``"shard_map"`` / ``"virtual"``.
    * ``axis``           — the name of the axis carrying the shards; in
                           ``shard_map`` mode the group bound to it by
                           :func:`axis_group` (default: WORLD).
    * ``target_backend`` — the device type the aggregation will run on
                           (``"cuda"``/``"cpu"``); ``round_backend="auto"``
                           keys off it instead of the tensors' device.
                           None = the tensors' device.
    """
    num_shards: int = 1
    mode: str = "gspmd"
    axis: str = "model"
    target_backend: str | None = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown ShardSpec mode {self.mode!r}; "
                             f"have {_MODES}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")

    @property
    def partitioned(self) -> bool:
        """Stacked gradients arrive as per-shard slices (any mode)."""
        return self.num_shards > 1

    @property
    def blocked(self) -> bool:
        """Reductions take the canonical blocked order (``shard_map`` or
        its ``virtual`` oracle)."""
        return self.partitioned and self.mode in ("shard_map", "virtual")


def target_backend_of(spec: ShardSpec | None) -> str | None:
    return spec.target_backend if spec is not None else None


def is_partitioned(spec: ShardSpec | None) -> bool:
    return spec is not None and spec.partitioned


def axis_group(axis: str, group):
    """Bind ``axis`` to the ``torch.distributed`` group ``group`` for the
    ``shard_map``-mode collectives run inside a ``with`` block; under a
    model mesh that has ``axis``, the mesh's group carries it and
    ``group`` must be None or that group (``meshctx.bind_axis``)."""
    return meshctx.bind_axis(axis, group)


def shard_group(spec: ShardSpec):
    """The group carrying ``spec.axis`` (``meshctx.axis_group_of``; None:
    the default group), checked to have ``spec.num_shards`` ranks."""
    group = meshctx.axis_group_of(spec.axis)
    world = dist.get_world_size(group)
    if world != spec.num_shards:
        raise ValueError(f"ShardSpec.num_shards={spec.num_shards} but the "
                         f"{spec.axis!r} group has {world} ranks")
    return group


def shard_index(spec: ShardSpec) -> int:
    """This rank's shard: its rank in the axis's group."""
    return dist.get_rank(shard_group(spec))


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (world,) + x.shape.

    Over a gloo group a CUDA tensor goes through the host and back, every
    time; what the port gathers is (k,)-, (m,)- or (m, m)-sized, or a
    data-axis rank's (k, ...) batch-mean contribution."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    local = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def shard_slice(leaf, index: int, num_shards: int):
    """Slice ``index`` of ``num_shards`` even splits of the LAST dim, as a
    contiguous tensor (the layout a rank holding it has)."""
    d = leaf.shape[-1]
    if d % num_shards != 0:
        raise ValueError(
            f"last dim {d} of leaf {tuple(leaf.shape)} does not divide into "
            f"{num_shards} shards")
    c = d // num_shards
    return leaf[..., index * c:(index + 1) * c].contiguous()


def chain_sum(parts):
    """Ordered shard-major combine as an unrolled left-to-right add chain
    over the leading axis."""
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc


def blocked_partial_sum(spec: ShardSpec | None, items, partial_fn, *,
                        shape=(), lead_axes: int = 1):
    """Canonical f32 sum of per-item coordinate reductions, blocked by shard.

    ``items`` is a sequence of leaves (or tuples of leaves sharing their
    trailing coordinate dims); ``partial_fn(*item)`` reduces one item's
    (slice of) coordinates to an f32 tensor of ``shape``.  The first
    ``lead_axes`` axes of an item's FIRST array are not coordinates; an
    item with no coordinate dims beyond them is replicated and belongs to
    shard 0.

    With no spec, or a ``gspmd`` one, this is the plain accumulation loop
    of the unsharded path.  With a blocked spec it is the ordered
    shard-major sum of per-shard partials, the same bits whether the
    shards are ranks (``shard_map``) or contiguous slices of whole leaves
    (``virtual``)."""
    items = [it if isinstance(it, tuple) else (it,) for it in items]
    device = items[0][0].device
    if spec is None or not spec.blocked:
        acc = torch.zeros(shape, dtype=torch.float32, device=device)
        for it in items:
            acc = acc + partial_fn(*it)
        return acc

    s = spec.num_shards

    def sharded(first, *, check_divisible: bool) -> bool:
        """A leaf with coordinate dims beyond the lead axes is partitioned
        (divisibility is checkable only where the whole leaf is seen)."""
        if first.ndim <= lead_axes:
            return False
        if check_divisible and first.shape[-1] % s != 0:
            raise ValueError(
                f"leaf {tuple(first.shape)} has coordinate dims but its last "
                f"dim does not divide into num_shards={s}; shard-local "
                "aggregation requires an even last-dim split")
        return True

    if spec.mode == "virtual":
        parts = []
        for i in range(s):
            acc = torch.zeros(shape, dtype=torch.float32, device=device)
            for it in items:
                if sharded(it[0], check_divisible=True):
                    acc = acc + partial_fn(*[shard_slice(a, i, s)
                                             for a in it])
                elif i == 0:
                    acc = acc + partial_fn(*it)
            parts.append(acc)
        return chain_sum(torch.stack(parts))

    # shard_map mode: every array of a sharded item is the local slice;
    # replicated items add on shard 0 only, as in the virtual oracle
    on_shard0 = shard_index(spec) == 0
    acc = torch.zeros(shape, dtype=torch.float32, device=device)
    for it in items:
        if sharded(it[0], check_divisible=False):
            acc = acc + partial_fn(*[a.contiguous() for a in it])
        elif on_shard0:
            acc = acc + partial_fn(*it)
    return chain_sum(all_gather(acc, shard_group(spec)))
