"""The ambient model mesh and its collectives (port of
``repro.models.meshctx``).

The reference builds a ``jax.sharding.Mesh`` of devices, installs it with
``jax.set_mesh`` and lets model code pick the sharded path when one is
ambient; inside ``shard_map`` each device sees its block of the global
arrays and the body's ``jax.lax`` collectives name mesh axes.  Here a
``Mesh`` is a grid of ``torch.distributed`` ranks (the default group,
ranks in row-major order over the axes, as ``jax.make_mesh`` lays out
devices); each rank already holds its block, and a region is a plain
function on local tensors that makes the same collectives as the
reference's shard_map body:

* ``all_gather(x, axes, dim)``: the tiled ``jax.lax.all_gather``; its
  gradient is ``psum_scatter`` of the cotangent;
* ``psum_scatter(x, axes, dim)``: the tiled ``jax.lax.psum_scatter``; its
  gradient is ``all_gather``;
* ``psum(x, axes)``: ``jax.lax.psum`` of a varying value to an invariant
  one; its gradient is the cotangent itself on every rank;
* ``pvary(x, axes)``: a value the same on every rank of ``axes`` (a
  replicated input of a shard_map region) entering varying code: the
  identity, whose gradient is summed over ``axes``, the transpose
  shard_map takes at the boundary of a replicated input;
* ``softmax_combine(m, l, o, axes)``: one softmax from the ranks' blocks
  of keys (decode on a cache cut over ``model``): the parts rescaled by
  the global max, summed in rank order, divided.

``stream_layout`` tells the regions whether the residual stream is cut
over ``model`` in T (sequence-parallel, and outside any layout) or whole
on every model rank (below the threshold, and decode).  ``Block`` is a
rank's block of a batch with the names of its leaves whose sequence dim
is cut over ``model`` and whether its rows are whole, recorded where the
batch is cut (``launch.sharding.local_batch``): the model reads the
stream's layout from it, never from a block's shape.

Every cross-rank sum is taken in rank order: the parts are exchanged
(``all_gather``, or ``all_to_all_single`` for ``psum_scatter``) and added
left to right, as ``core.shard_aggregation.chain_sum`` does, never by
``dist.all_reduce``'s unspecified order, so two runs give the same bits.
Tensors travel as raw bytes, a CUDA tensor staged through the host and
back (NCCL refuses two ranks of one card): over the group's backend, or,
where ``use_local_transport`` names a directory (``launch.ranks`` does,
its ranks sharing one host), through a file there that the group's ranks
map (``_Arena``: a slot a rank, counters the ranks poll), which spares
each collective gloo's round trips through the socket layer.  The bytes
are the same either way.  ``Mesh.stats`` counts a mesh's collectives,
their bytes and their milliseconds (the staging included), and by kind
(``KINDS``) their calls, ``result_bytes`` (the collective's result a
rank, the reference's convention: a psum's is one part) and
``wire_bytes`` (what the transport received: a psum gathers its n parts);
``Mesh.reset_stats`` zeroes it.  ``Mesh.abstract(shape, axes, rank)`` is
one rank's view of a mesh with no process group: the dry run
(``launch.dryrun``) traces that rank's program on fake tensors through
its transport, which moves no bytes and counts as a real one does.

The mesh also carries the one registry of axis groups:
``core.shard_aggregation`` reads an axis's group through
``axis_group_of`` (the ambient mesh's, where it has the axis).

Layouts: a spec tuple (one entry a dim: None, an axis, or a tuple of axes
in mesh order) cuts a whole tensor into the blocks ``cut`` gives each
rank; ``launch.sharding.gather_tree`` joins the blocks back;
``block_indices`` names a block's elements by their flat indices in the
whole tensor (a sharded random draw computes only those).
``param_sums_deferred`` hands the gradient sums that model code takes at
a leaf's entry (``pvary``) to a caller that takes them itself: the
trainer's storage layout reduce-scatters them (``launch.sharding``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
import mmap
import os
import platform
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

_MESH: contextvars.ContextVar = contextvars.ContextVar("model_mesh",
                                                      default=None)
# axis -> group bound outside a mesh (core.shard_aggregation.axis_group)
_BOUND: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "bound_axis_groups", default={})
_DEFERRED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "param_sums_deferred", default=False)
# whether the residual stream a region runs on is cut over ``model`` in T
_STREAM_CUT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "stream_cut", default=True)


class Mesh:
    """A grid of the default group's ranks: ``shape`` ranks over
    ``axis_names``, rank r at the row-major coordinates of r.

    Building one creates a process group for every non-empty set of axes
    (each axis, the data axes together, all of them, ...): every rank
    calls ``dist.new_group`` for every group, in one order, the groups it
    is not in included, as ``torch.distributed`` requires.  A group's
    ranks are in ascending order, which is row-major over its axes in
    mesh order: a tiled gather over ("pod", "data") is pod-major, as in
    the reference."""

    def __init__(self, shape, axis_names):
        shape, axis_names = _check_shape(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("a Mesh is a grid of torch.distributed ranks: "
                               "initialise the default group first")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} holds "
                             f"{math.prod(shape)} ranks, the default group "
                             f"{world}")
        self._setup(shape, axis_names, dist.get_rank(), dist.new_group)

    @classmethod
    def abstract(cls, shape, axis_names, rank: int) -> "Mesh":
        """The mesh as rank ``rank`` of it sees it, with no process group:
        the same ``coords``, group ranks, ``size`` and ``index``; its
        collectives take fake tensors only and return fake tensors of the
        received shapes (the dry run's transport), counted in ``stats``
        as a real mesh counts them."""
        shape, axis_names = _check_shape(shape, axis_names)
        if not 0 <= rank < math.prod(shape):
            raise ValueError(f"rank {rank} is not in a mesh of "
                             f"{math.prod(shape)} ranks")
        mesh = cls.__new__(cls)
        mesh._setup(shape, axis_names, int(rank),
                    lambda ranks: _AbstractGroup(tuple(ranks)))
        return mesh

    @property
    def is_abstract(self) -> bool:
        return self._abstract

    def _setup(self, shape, axis_names, rank, new_group):
        self._abstract = new_group is not dist.new_group
        world = math.prod(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.stats = {}
        self.reset_stats()
        self.rank = rank
        coords, r = [], self.rank
        for size in reversed(shape):
            coords.append(r % size)
            r //= size
        self.coords = dict(zip(axis_names, reversed(coords)))
        self._groups = {}
        all_coords = list(itertools.product(*(range(s) for s in shape)))
        for n in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n):
                others = [i for i, a in enumerate(axis_names)
                          if a not in axes]
                members = {}
                for rank, c in enumerate(all_coords):
                    members.setdefault(tuple(c[i] for i in others),
                                       []).append(rank)
                for ranks in members.values():
                    if len(ranks) == world:
                        group = None                        # the default
                    elif len(ranks) == 1:
                        group = None                        # never used
                    else:
                        group = new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = (group, tuple(ranks))

    def reset_stats(self) -> None:
        """Zero the count of collectives, their bytes and milliseconds,
        the counts by kind, and the bytes received by group (``groups``:
        "axis,axis" -> bytes); new dicts, so a copy of the old stats keeps
        its own."""
        self.stats.update(calls=0, bytes=0, ms=0.0, kinds={
            kind: dict(calls=0, result_bytes=0, wire_bytes=0)
            for kind in KINDS}, groups={})

    def axes_of(self, group):
        """The axes whose group is ``group`` (None: the default group, the
        whole mesh), or None where no set of this mesh's axes has it."""
        if group is None:
            return self.axis_names
        for axes, (g, _) in self._groups.items():
            if g is group:
                return axes
        return None

    def axes(self, axes) -> tuple:
        """``axes`` (a name or a tuple of names) in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown or not names:
            raise ValueError(f"axes {axes!r} are not a non-empty set of the "
                             f"mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes):
        """This rank's group over ``axes`` and its ranks, in order."""
        return self._groups[self.axes(axes)]

    def size(self, axes) -> int:
        return len(self.group(axes)[1])

    def index(self, axes) -> int:
        """This rank's place in its group over ``axes``."""
        return self.group(axes)[1].index(self.rank)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


# the kinds of collective ``Mesh.stats`` counts: a gather, a sum on every
# rank, a sum scattered, and an exchange of blocks
KINDS = ("all_gather", "psum", "psum_scatter", "all_to_all")


def _check_shape(shape, axis_names):
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(
            axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                         "must pair one size with each distinct name")
    return shape, axis_names


class _AbstractGroup:
    """An abstract mesh's stand-in for a process group: its ranks; no
    ``torch.distributed`` call takes it."""

    def __init__(self, ranks):
        self.ranks = ranks

    def __repr__(self):
        return f"_AbstractGroup({self.ranks})"


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh for a ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh | None:
    return _MESH.get()


def axis_group_of(axis: str):
    """The group carrying ``axis``: the ambient mesh's where it has the
    axis, else the one bound by ``bind_axis`` (None: the default
    group)."""
    mesh = current_mesh()
    if mesh is not None and axis in mesh.axis_names:
        return mesh.group(axis)[0]
    return _BOUND.get().get(axis)


def axis_place(axis: str):
    """(group, size, this rank's index) of the group carrying ``axis``
    (``axis_group_of``): the ambient mesh's count and index where it has
    the axis (an abstract mesh's groups take no ``torch.distributed``
    call), else the bound group's."""
    mesh = current_mesh()
    if mesh is not None and axis in mesh.axis_names:
        return mesh.group(axis)[0], mesh.size(axis), mesh.index(axis)
    group = _BOUND.get().get(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


@contextlib.contextmanager
def bind_axis(axis: str, group):
    """Bind ``axis`` to ``group`` for a ``with`` block.  Under a mesh that
    has ``axis`` the mesh's group carries it: ``group`` must be None or
    that group."""
    mesh = current_mesh()
    if mesh is not None and axis in mesh.axis_names:
        if group is not None and group is not mesh.group(axis)[0]:
            raise ValueError(f"axis {axis!r} is the ambient mesh's; bind "
                             "no other group to it")
        yield
        return
    token = _BOUND.set({**_BOUND.get(), axis: group})
    try:
        yield
    finally:
        _BOUND.reset(token)


@contextlib.contextmanager
def param_sums_deferred():
    """For a ``with`` block, model code under the mesh leaves its params'
    entry sums (``pvary`` over the axes a leaf is replicated on) to the
    caller: each leaf's gradient comes back as this rank's partial, but
    where a region sums it itself."""
    token = _DEFERRED.set(True)
    try:
        yield
    finally:
        _DEFERRED.reset(token)


def param_sums_are_deferred() -> bool:
    return _DEFERRED.get()


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` of the ambient mesh."""
    return current_mesh().coords[axis]


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1


def all_axes(mesh) -> tuple[str, ...]:
    """The data axes and ``model``: every rank of the mesh."""
    return data_axes(mesh) + (("model",) if "model" in mesh.axis_names
                              else ())


def dspec(mesh):
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def sp_applicable(mesh, batch: int, seq: int) -> bool:
    """Sequence-parallel attention needs batch % data == 0 and
    seq % model == 0 (global sizes), and seq >= 16 model ranks."""
    if mesh is None or "model" not in mesh.axis_names or not data_axes(mesh):
        return False
    return batch % data_size(mesh) == 0 and seq % model_size(mesh) == 0 \
        and seq >= model_size(mesh) * 16


@contextlib.contextmanager
def stream_layout(cut: bool):
    """For a ``with`` block, the regions run on a stream cut over ``model``
    in T (``cut``: the sequence-parallel layout), or on the data shard's
    rows with T whole on every model rank (the reference's dense fallback
    below the threshold, and decode)."""
    token = _STREAM_CUT.set(bool(cut))
    try:
        yield
    finally:
        _STREAM_CUT.reset(token)


def stream_is_cut() -> bool:
    """Whether a region's stream on this rank is its T block, as
    ``stream_layout`` says (cut outside one: a region called alone runs
    the sequence-parallel layout)."""
    return _STREAM_CUT.get()


class Block(dict):
    """A rank's block of a batch (``launch.sharding.local_batch``): its
    leaves, ``cut``, the names of those whose sequence dim (after the
    rows) is cut over ``model``, and ``rows_whole``, whether its rows are
    the whole batch (rows the data axes do not divide: the reference's
    ``serve_batch_spec`` keeps them whole on every data rank) rather than
    the data shard's.  A pytree node that keeps both, so ``tree_map``
    over the block (a group's rows, a microbatch) keeps them."""

    def __init__(self, leaves=(), cut=(), rows_whole: bool = False):
        super().__init__(leaves)
        self.cut = frozenset(cut)
        self.rows_whole = bool(rows_whole)


_pytree.register_pytree_node(
    Block, lambda b: (list(b.values()), (tuple(b), b.cut, b.rows_whole)),
    lambda values, ctx: Block(zip(ctx[0], values), ctx[1], ctx[2]),
    serialized_type_name="repro_torch.models.meshctx.Block")


def constrain(x, spec_tuple):
    """The reference's sharding constraint; on a rank's local block there
    is nothing to constrain."""
    return x


# ---------------------------------------------------------------------------
# transport: parts in rank order, sums left to right

def _as_bytes(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def _transfer(x, mesh, axes, exchange: str, kind: str, result_bytes: int):
    """``x``'s bytes through the transport of ``mesh``'s group over
    ``axes``: ``exchange`` "gather" -> (n, bytes), every rank's in order;
    "all_to_all" -> (bytes,), block j of every rank's n blocks to rank j.
    Staged through the host when ``x`` lies on the card.  An abstract
    mesh takes fake tensors only and returns a fake tensor of the received
    shape on ``x``'s device.  Counted in ``mesh.stats``: the totals, and
    under ``kind`` the calls, the result's bytes a rank (``result_bytes``,
    the reference's convention) and the bytes the transport received."""
    group, ranks = mesh.group(axes)
    n = len(ranks)
    t0 = time.perf_counter()
    if mesh.is_abstract:
        from torch._subclasses.fake_tensor import is_fake
        if not is_fake(x):
            raise RuntimeError("an abstract mesh's collectives take fake "
                               "tensors only (a dry trace); got a real "
                               f"{x.device} tensor")
        local = _as_bytes(x.detach())
        shape = (n, local.numel()) if exchange == "gather" \
            else (local.numel(),)
        out = torch.empty(shape, dtype=torch.uint8, device=x.device)
    else:
        local = _as_bytes(x.detach().cpu() if x.is_cuda else x.detach())
        out = (_gather_bytes if exchange == "gather"
               else _all_to_all_bytes)(local, group, ranks)
        if x.is_cuda:
            out = out.to(x.device)
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += local.numel()
    mesh.stats["ms"] += (time.perf_counter() - t0) * 1e3
    counts = mesh.stats["kinds"][kind]
    counts["calls"] += 1
    counts["result_bytes"] += int(result_bytes)
    counts["wire_bytes"] += out.numel()
    groups = mesh.stats["groups"]
    key = ",".join(axes)
    groups[key] = groups.get(key, 0) + out.numel()
    return out


# the directory of the local transport's files (None: the group's backend)
_LOCAL_DIR: str | None = None
_ARENAS: dict = {}


def use_local_transport(directory: str | None) -> None:
    """Exchange this process's mesh collectives through files mapped in
    ``directory``, which every rank of the default group shares on one
    host (None: over the groups' backend).  x86-64 hosts only: a rank
    marks its slot written with a plain store after the data's, which
    x86-64 makes visible in that order; elsewhere the groups' backend
    stays."""
    global _LOCAL_DIR
    _LOCAL_DIR = directory if platform.machine() in ("x86_64",
                                                     "AMD64") else None
    _ARENAS.clear()


class _Arena:
    """The local transport of one set of ranks: a file of ``SLOT`` bytes a
    rank, and two counters a rank, ``written`` and ``read``, the rounds it
    has put in its slot and taken from every slot.  A round writes this
    rank's slot once every rank has read the last round, marks it written,
    waits for every rank's mark, reads and marks it read.  The ranks of a
    group call its collectives in one order (as over any backend), so
    their rounds pair up; a wait longer than ``WAIT_S`` raises."""

    SLOT = 32 << 20
    WAIT_S = 600.0

    def __init__(self, directory, ranks, rank):
        n = len(ranks)
        path = os.path.join(directory,
                            "mesh-" + "-".join(str(r) for r in ranks))
        size = 4096 + n * self.SLOT
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            if os.fstat(fd).st_size < size:
                os.ftruncate(fd, size)
            self._map = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        counts = np.frombuffer(self._map, dtype=np.int64, count=2 * n)
        self.written, self.read = counts[:n], counts[n:]
        # numpy's copies: one thread each (torch's would start its thread
        # pool in every rank at once for a few kilobytes)
        self.slots = np.frombuffer(self._map, dtype=np.uint8, offset=4096,
                                   count=n * self.SLOT).reshape(n, self.SLOT)
        self.n, self.me, self.round = n, ranks.index(rank), 0

    def _wait(self, counts, at_least):
        spins, t0 = 0, None
        while counts.min() < at_least:
            spins += 1
            if spins <= 256:
                continue
            if t0 is None:
                t0 = time.monotonic()
            if spins <= 2048:
                os.sched_yield()
            else:
                time.sleep(1e-4)
            if spins % 1024 == 0 and time.monotonic() - t0 > self.WAIT_S:
                raise TimeoutError(
                    f"mesh transport: ranks' counts {counts.tolist()} still "
                    f"below round {at_least} after {self.WAIT_S} s")

    def exchange(self, put, take):
        """One round: ``put(slot)`` into this rank's slot, then
        ``take(slots)`` from all of them."""
        self.round += 1
        self._wait(self.read, self.round - 1)
        put(self.slots[self.me])
        self.written[self.me] = self.round
        self._wait(self.written, self.round)
        take(self.slots)
        self.read[self.me] = self.round

    def all_gather(self, local):
        """(n, bytes): every rank's ``local`` (of one size), in order."""
        src = local.numpy()
        nb = src.size
        out = np.empty((self.n, nb), dtype=np.uint8)
        # an empty payload makes one round too: every rank, the same rounds
        for o in range(0, nb, self.SLOT) or [0]:
            c = min(self.SLOT, nb - o)
            self.exchange(lambda slot: np.copyto(slot[:c], src[o:o + c]),
                          lambda slots: np.copyto(out[:, o:o + c],
                                                  slots[:, :c]))
        return torch.from_numpy(out)

    def all_to_all(self, local):
        """``local``'s n equal blocks, block j to rank j -> the blocks the
        ranks sent this one, in order."""
        n, me = self.n, self.me
        rows = local.numpy().reshape(n, -1)
        b = rows.shape[1]
        out = np.empty_like(rows)
        step = self.SLOT // n
        for o in range(0, b, step) or [0]:
            c = min(step, b - o)
            self.exchange(
                lambda slot: np.copyto(slot[:n * c].reshape(n, c),
                                       rows[:, o:o + c]),
                lambda slots: np.copyto(out[:, o:o + c],
                                        slots[:, me * c:(me + 1) * c]))
        return torch.from_numpy(out.reshape(-1))


def _arena(ranks):
    """This process's arena for ``ranks`` under the local transport, else
    None."""
    if _LOCAL_DIR is None:
        return None
    arena = _ARENAS.get(ranks)
    if arena is None:
        arena = _ARENAS[ranks] = _Arena(_LOCAL_DIR, ranks, dist.get_rank())
    return arena


def _gather_bytes(local, group, ranks):
    arena = _arena(ranks)
    if arena is not None:
        return arena.all_gather(local)
    out = torch.empty((len(ranks), local.numel()), dtype=torch.uint8)
    dist.all_gather(list(out.unbind(0)), local, group=group)
    return out


def _all_to_all_bytes(local, group, ranks):
    arena = _arena(ranks)
    if arena is not None:
        return arena.all_to_all(local)
    out = torch.empty_like(local)
    dist.all_to_all_single(out, local, group=group)
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _parts(x, mesh, axes, kind: str = "all_gather"):
    """Every rank's ``x`` over ``axes``, in group order: (n, *x.shape),
    counted as ``kind`` (a gather; "psum": the parts of a sum, whose
    result is one part)."""
    n = len(mesh.group(axes)[1])
    if n == 1:
        return x[None]
    result = _nbytes(x) * (n if kind == "all_gather" else 1)
    return _transfer(x, mesh, axes, "gather", kind, result).view(
        x.dtype).reshape(n, *x.shape)


def parts(x, axes, *, mesh=None):
    """Every rank's ``x`` over ``axes`` of the (ambient) mesh, stacked in
    rank order: (n, *x.shape), through the mesh's transport (no
    autograd)."""
    mesh = _mesh_for(mesh)
    return _parts(x, mesh, mesh.axes(axes))


def _chain(parts):
    rows = parts.unbind(0)
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc


def _all_gather(x, mesh, axes, dim):
    parts = _parts(x, mesh, axes)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _psum(x, mesh, axes):
    return _chain(_parts(x, mesh, axes, "psum"))


def softmax_combine(m, l, o, axes, *, mesh=None):
    """One softmax over keys split across the ranks of ``axes``, from each
    rank's block: ``m`` (...) its row maxima, ``l`` (...) its sums of
    exp(s - m), ``o`` (..., n) its unnormalised outputs sum exp(s - m) v,
    all float32.  The three are exchanged in one gather; every part is
    rescaled by exp(m_r - M), M the maximum over the ranks, summed in rank
    order and divided: o / l of the whole softmax, on every rank.  A
    rank whose keys are all masked (m at the mask's -1e30) adds exactly 0.
    No gradient."""
    mesh = _mesh_for(mesh)
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1).detach()
    parts = _parts(packed, mesh, mesh.axes(axes))
    ms, ls, os_ = parts[..., 0], parts[..., 1], parts[..., 2:]
    scale = torch.exp(ms - ms.amax(0))
    return _chain(scale[..., None] * os_) / _chain(scale * ls)[..., None]


def _psum_scatter(x, mesh, axes, dim):
    n = len(mesh.group(axes)[1])
    if x.shape[dim] % n != 0:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split into {n} ranks")
    if n == 1:
        return x
    chunks = torch.stack(x.chunk(n, dim))          # (n, *chunk) to rank j
    mine = _transfer(chunks, mesh, axes, "all_to_all", "psum_scatter",
                     _nbytes(x) // n).view(x.dtype).reshape(chunks.shape)
    return _chain(mine)


def _parts_many(xs, mesh, axes, kind: str = "all_gather"):
    """``_parts`` of every tensor of ``xs`` in one gather: their bytes side
    by side."""
    n = len(mesh.group(axes)[1])
    if n == 1 or len(xs) == 1:
        return [_parts(x, mesh, axes, kind) for x in xs]
    flat = torch.cat([_as_bytes(x) for x in xs])
    rows = _parts(flat, mesh, axes, kind)          # (n, bytes)
    out, off = [], 0
    for x in xs:
        nb = x.numel() * x.element_size()
        out.append(rows[:, off:off + nb].contiguous().view(x.dtype)
                   .reshape(n, *x.shape))
        off += nb
    return out


def _all_gather_many(xs, mesh, axes, dims):
    """``_all_gather`` of each tensor along its dim, in one collective
    (no autograd)."""
    return [torch.cat(list(p.unbind(0)), dim=d)
            for p, d in zip(_parts_many(xs, mesh, axes), dims)]


def _psum_many(xs, mesh, axes):
    """``_psum`` of each tensor, in one collective (no autograd)."""
    return [_chain(p) for p in _parts_many(xs, mesh, axes, "psum")]


def _psum_scatter_many(xs, mesh, axes, dims):
    """``_psum_scatter`` of each tensor along its dim, in one exchange (no
    autograd)."""
    n = len(mesh.group(axes)[1])
    if n == 1:
        return list(xs)
    if len(xs) == 1:
        return [_psum_scatter(xs[0], mesh, axes, dims[0])]
    chunks = []
    for x, d in zip(xs, dims):
        if x.shape[d] % n != 0:
            raise ValueError(f"psum_scatter: dim {d} of {tuple(x.shape)} "
                             f"does not split into {n} ranks")
        chunks.append(torch.stack(x.chunk(n, d)))
    rows = torch.cat([c.reshape(n, -1).view(torch.uint8) for c in chunks],
                     dim=1)                        # (n, bytes): row j to j
    got = _transfer(rows, mesh, axes, "all_to_all", "psum_scatter",
                    rows.numel() // n).reshape(n, -1)
    out, off = [], 0
    for c in chunks:
        nb = c[0].numel() * c.element_size()
        out.append(_chain(got[:, off:off + nb].contiguous().view(c.dtype)
                          .reshape(c.shape)))
        off += nb
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, \
            None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllGatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dims, *xs):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        return tuple(_all_gather_many(list(xs), mesh, axes, dims))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_psum_scatter_many(
            list(gs), ctx.mesh, ctx.axes, ctx.dims))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axes), None, None


def _mesh_for(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("a mesh collective needs a mesh: call it under "
                           "set_mesh or pass mesh=")
    return mesh


def _dim(x, dim):
    return dim % x.ndim


def all_gather(x, axes, dim: int, *, mesh=None):
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    mesh = _mesh_for(mesh)
    return _AllGather.apply(x, mesh, mesh.axes(axes), _dim(x, dim))


def all_gather_many(xs, axes, dim: int, *, mesh=None):
    """``all_gather`` of each tensor of ``xs`` along ``dim``, in one
    collective (their bytes side by side)."""
    mesh = _mesh_for(mesh)
    return list(_AllGatherMany.apply(mesh, mesh.axes(axes),
                                     tuple(_dim(x, dim) for x in xs), *xs))


def psum_scatter(x, axes, dim: int, *, mesh=None):
    """The sum over ``axes`` in rank order, split along ``dim``: this
    rank's piece (``jax.lax.psum_scatter(..., tiled=True)``)."""
    mesh = _mesh_for(mesh)
    return _PsumScatter.apply(x, mesh, mesh.axes(axes), _dim(x, dim))


def psum(x, axes, *, mesh=None):
    """The sum of ``x`` over ``axes`` in rank order, on every rank."""
    mesh = _mesh_for(mesh)
    return _Psum.apply(x, mesh, mesh.axes(axes))


def pvary(x, axes, *, mesh=None):
    """``x``, the same on every rank of ``axes``, entering code whose
    values differ by rank: the identity, with its gradient summed over
    ``axes``."""
    mesh = _mesh_for(mesh)
    axes = mesh.axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _Pvary.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# layouts: spec tuples over a mesh's shape

def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (None: no axis)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> set:
    """Every axis a spec tuple cuts over."""
    return {a for e in spec for a in entry_axes(e)}


def block_index(axes, coords, sizes) -> tuple[int, int]:
    """(this block's index, the number of blocks) of a dim cut over
    ``axes``: row-major over them, as a tiled gather over them orders
    the ranks."""
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def cut(t, spec, coords, sizes):
    """The block of the whole tensor ``t`` that the rank at ``coords``
    holds under ``spec`` (which lays out ``t``'s trailing dims), as a
    contiguous tensor."""
    lead = t.ndim - len(spec)
    if lead < 0:
        raise ValueError(f"spec {spec} has more dims than {tuple(t.shape)}")
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx, n = block_index(axes, coords, sizes)
        size = t.shape[lead + d]
        if size % n != 0:
            raise ValueError(f"dim {lead + d} of {tuple(t.shape)} does not "
                             f"split into {n} blocks over {axes}")
        c = size // n
        t = t.narrow(lead + d, idx * c, c)
    return t.contiguous()


def whole_shape(block_shape, spec, sizes) -> tuple:
    """The whole tensor's shape from a block's under ``spec``."""
    lead = len(block_shape) - len(spec)
    out = list(block_shape)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[lead + d] *= sizes[a]
    return tuple(out)


def block_indices(shape, spec, coords, sizes, start: int = 0,
                  stop: int | None = None, *, device=None):
    """The flat indices, in the whole ``shape``'s row-major order, of the
    block ``cut(t, spec, coords, sizes)`` gives, at the block's own
    row-major positions ``start`` to ``stop`` (default: all of it): an
    int64 tensor of ``stop - start``."""
    shape = tuple(int(s) for s in shape)
    lead = len(shape) - len(spec)
    if lead < 0:
        raise ValueError(f"spec {spec} has more dims than {shape}")
    dims, offs = list(shape), [0] * len(shape)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx, n = block_index(axes, coords, sizes)
        if shape[lead + d] % n != 0:
            raise ValueError(f"dim {lead + d} of {shape} does not split "
                             f"into {n} blocks over {axes}")
        dims[lead + d] = shape[lead + d] // n
        offs[lead + d] = idx * dims[lead + d]
    stop = math.prod(dims) if stop is None else stop
    pos = torch.arange(start, stop, dtype=torch.int64, device=device)
    flat = torch.zeros_like(pos)
    stride = 1
    for d in reversed(range(len(shape))):
        flat += (pos % dims[d] + offs[d]) * stride
        pos = pos // dims[d]
        stride *= shape[d]
    return flat


def one_card_turns(mesh, fn, device):
    """``fn()`` on every rank; where the mesh's ranks share one card, one
    rank at a time in rank order, each emptying its allocator's cache
    before and after its turn, so that one rank's scratch at a time holds
    the card (a barrier over the mesh between turns).  An abstract mesh
    runs ``fn`` once: its one rank has no card to share."""
    world = math.prod(mesh.shape.values())
    dev = torch.device(device)
    if (mesh.is_abstract or dev.type != "cuda"
            or torch.cuda.device_count() >= world):
        return fn()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    out = None
    for r in range(world):
        if r == mesh.rank:
            out = fn()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        dist.barrier()
    return out
