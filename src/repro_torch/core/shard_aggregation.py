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

The 2D layout (:func:`layout_spec`): a ``ShardSpec`` with ``layout``
carries each stacked leaf's spec tuple (``launch.sharding.
stacked_grad_shardings``, in ``tree_leaves`` order) over a model mesh of
``mesh_shape``, so a leaf may be cut on any dims, over ``data``,
``model`` or both.  Each rank's partial is over its own blocks; a block
replicated over some axes is counted only by the rank at coordinate 0 on
them; the partials are gathered over the whole mesh in rank order and
chain-summed.  The ``virtual`` oracle cuts the whole leaves by the same
specs, rank by rank (``meshctx.cut``), so the two give the same bits.
Code that reduces a stacked tree without a ``shard_spec`` argument (the
attacks and schedules, the optimizer's clip norm) reads the layout
installed by :func:`use_layout`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.models import meshctx

# repro_torch: bit-stable — reductions in this module keep a fixed
# expression tree on every device: the unrolled chain_sum, never
# torch.sum/.mean over the shard/member axis (repro_torch.verify
# RV101/RV105).

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
    layout: tuple | None = None
    mesh_shape: tuple = ()

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown ShardSpec mode {self.mode!r}; "
                             f"have {_MODES}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        if self.layout is not None:
            if self.mode == "gspmd":
                raise ValueError("a layout ShardSpec runs blocked "
                                 "reductions: mode 'shard_map' or 'virtual'")
            names = {a for a, _ in self.mesh_shape}
            for s in self.layout:
                if not meshctx.spec_axes(s) <= names:
                    raise ValueError(f"layout spec {s} names an axis not in "
                                     f"the mesh {self.mesh_shape}")

    @property
    def partitioned(self) -> bool:
        """Stacked gradients arrive as per-shard slices (any mode)."""
        if self.layout is not None:
            return any(meshctx.spec_axes(s) for s in self.layout)
        return self.num_shards > 1

    @property
    def blocked(self) -> bool:
        """Reductions take the canonical blocked order (``shard_map`` or
        its ``virtual`` oracle)."""
        return self.partitioned and self.mode in ("shard_map", "virtual")


def layout_spec(layout, mesh_shape, *, mode: str = "shard_map",
                target_backend: str | None = None) -> ShardSpec:
    """The 2D layout's spec: ``layout`` the stacked leaves' spec tuples in
    ``tree_leaves`` order, ``mesh_shape`` the mesh's ((axis, size), ...)
    in mesh order."""
    mesh_shape = tuple((str(a), int(n)) for a, n in mesh_shape)
    return ShardSpec(num_shards=math.prod(n for _, n in mesh_shape),
                     mode=mode, axis="mesh", target_backend=target_backend,
                     layout=tuple(tuple(s) for s in layout),
                     mesh_shape=mesh_shape)


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("shard_layout",
                                                        default=None)


@contextlib.contextmanager
def use_layout(spec: ShardSpec | None):
    """Install ``spec`` (a layout spec, or None) as the layout that code
    reducing a stacked tree without a ``shard_spec`` argument reads."""
    token = _LAYOUT.set(spec)
    try:
        yield spec
    finally:
        _LAYOUT.reset(token)


def current_layout() -> ShardSpec | None:
    return _LAYOUT.get()


def leaf_spec(spec: ShardSpec | None, i: int) -> ShardSpec | None:
    """The spec of leaf ``i`` alone: a layout spec cut to its one entry;
    any other spec as it is."""
    if spec is None or spec.layout is None:
        return spec
    return dataclasses.replace(spec, layout=(spec.layout[i],))


def leaf_specs(spec: ShardSpec | None, tree) -> list:
    """Each leaf's own spec (``leaf_spec``) in JAX's leaf order of
    ``tree`` (``repro_torch.tree.leaves``; a layout lists its specs in
    ``tree_leaves`` order), or ``spec`` itself for every leaf where it
    has no layout."""
    leaves, treespec = tree_flatten(tree)
    if spec is None or spec.layout is None:
        return [spec] * len(leaves)
    order = jtree.leaves(tree_unflatten(list(range(len(leaves))), treespec))
    return [leaf_spec(spec, i) for i in order]


def sq_norm(spec: ShardSpec | None, arrays, *, lead_axes: int = 0):
    """The f32 sum of squares of every array, as one blocked sum where
    ``spec`` is blocked."""
    return blocked_partial_sum(
        spec, list(arrays),
        lambda x: torch.sum(torch.square(x.to(torch.float32))),
        shape=(), lead_axes=lead_axes)


def draw_block(spec: ShardSpec | None, block, key, dist: str):
    """This rank's block of ``repro_torch.random``'s ``dist`` ("uniform"
    or "normal") draw from ``key`` of the whole leaf whose block is
    ``block`` (``spec`` that leaf's own, ``leaf_spec``).  Under a
    ``shard_map`` layout only the block is computed (``<dist>_at`` at
    its ``meshctx.block_indices``, ``prng.DRAW_CHUNK`` positions at a
    time): the same bits as its cut of the whole draw.  Otherwise the
    leaf is whole (no layout, or the ``virtual`` oracle's whole leaves)
    and so is the draw."""
    shape = tuple(block.shape)
    if spec is None or spec.layout is None or spec.mode != "shard_map":
        return getattr(prng, dist)(key, shape)
    mesh = _layout_mesh(spec)
    s = spec.layout[0][1:]
    whole = meshctx.whole_shape(shape, s, mesh.shape)
    draw_at = getattr(prng, dist + "_at")
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=block.device)
    for lo in range(0, n, prng.DRAW_CHUNK):
        hi = min(lo + prng.DRAW_CHUNK, n)
        out[lo:hi] = draw_at(key, whole, meshctx.block_indices(
            whole, s, mesh.coords, mesh.shape, lo, hi, device=block.device))
    return out.reshape(shape)


def _layout_mesh(spec: ShardSpec):
    mesh = meshctx.current_mesh()
    if mesh is None or tuple(mesh.shape.items()) != spec.mesh_shape:
        raise ValueError(f"a shard_map layout over {spec.mesh_shape} runs "
                         "under that model mesh (meshctx.set_mesh)")
    return mesh


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


def _place(spec: ShardSpec):
    """(group, index) of this rank on ``spec.axis`` (``meshctx.axis_place``;
    group None: the default group), the group checked to have
    ``spec.num_shards`` ranks."""
    group, world, index = meshctx.axis_place(spec.axis)
    if world != spec.num_shards:
        raise ValueError(f"ShardSpec.num_shards={spec.num_shards} but the "
                         f"{spec.axis!r} group has {world} ranks")
    return group, index


def shard_group(spec: ShardSpec):
    """The group carrying ``spec.axis``, checked to have
    ``spec.num_shards`` ranks."""
    return _place(spec)[0]


def shard_index(spec: ShardSpec) -> int:
    """This rank's shard: its rank in the axis's group."""
    return _place(spec)[1]


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (world,) + x.shape.

    Where a model mesh is ambient and ``group`` is one of its groups (None:
    the whole mesh), through the mesh's transport (``meshctx.parts``), so
    that ``Mesh.stats`` counts it and a dry trace passes through it; the
    same bits.  Otherwise over ``group``: over gloo a CUDA tensor goes
    through the host and back, every time; what the port gathers is
    (k,)-, (m,)- or (m, m)-sized, or a data-axis rank's (k, ...)
    batch-mean contribution."""
    mesh = meshctx.current_mesh()
    axes = mesh.axes_of(group) if mesh is not None else None
    if axes is not None:
        return meshctx.parts(x, axes, mesh=mesh)
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
    rows = parts.unbind(0)
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
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
    if spec.layout is not None:
        return _layout_partial_sum(spec, items, partial_fn, shape, lead_axes)

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


def _owns(pspec, coords) -> bool:
    """A block is counted by the rank at coordinate 0 on every axis it is
    replicated over."""
    used = meshctx.spec_axes(pspec)
    return all(c == 0 for a, c in coords.items() if a not in used)


def _layout_partial_sum(spec: ShardSpec, items, partial_fn, shape,
                        lead_axes):
    if len(items) != len(spec.layout):
        raise ValueError(f"{len(items)} items for a layout of "
                         f"{len(spec.layout)} leaves")
    pspecs = []
    for it, s in zip(items, spec.layout):
        if it[0].ndim - lead_axes != len(s) - 1:
            raise ValueError(f"leaf {tuple(it[0].shape)} (lead axes "
                             f"{lead_axes}) does not match its stacked "
                             f"spec {s}")
        pspecs.append(s[1:])
    device = items[0][0].device

    def rank_partial(coords, block_of):
        acc = torch.zeros(shape, dtype=torch.float32, device=device)
        for it, ps in zip(items, pspecs):
            if _owns(ps, coords):
                acc = acc + partial_fn(*[block_of(a, ps) for a in it])
        return acc

    if spec.mode == "virtual":
        sizes = dict(spec.mesh_shape)
        names = [a for a, _ in spec.mesh_shape]
        parts = []
        for c in itertools.product(*(range(n) for _, n in spec.mesh_shape)):
            coords = dict(zip(names, c))
            parts.append(rank_partial(
                coords, lambda a, ps: meshctx.cut(a, ps, coords, sizes)))
        return chain_sum(torch.stack(parts))
    mesh = _layout_mesh(spec)
    acc = rank_partial(mesh.coords, lambda a, ps: a.contiguous())
    return chain_sum(all_gather(acc, mesh.group(mesh.axis_names)[0]))
