"""Mesh construction (port of ``repro.launch.mesh``).

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model").

The Byzantine worker axis is ``data`` (x ``pod`` on multi-pod).  A mesh
here is a grid of the ranks of the initialised default
``torch.distributed`` group (``models.meshctx.Mesh``): the reference's
devices become rank processes, as ``launch/ranks.py`` starts them.  Every
rank builds the same mesh (it creates the mesh's groups collectively).
Given a ``rank``, the functions return that rank's view of the mesh
(``Mesh.abstract``: no process group, a transport of fake tensors), which
the dry run (``launch.dryrun``) traces.  Functions, not module constants:
importing this module touches no process group.
"""

from __future__ import annotations

import math

from repro_torch.models.meshctx import Mesh


def make_mesh(shape, axes, *, rank: int | None = None) -> Mesh:
    """A mesh of ``shape`` ranks over ``axes``; raises unless the default
    group's world size is the product of ``shape``.  With ``rank``: that
    rank's abstract view, with no process group."""
    if rank is not None:
        return Mesh.abstract(tuple(shape), tuple(axes), rank)
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int | None = None) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): 256 or 512 ranks; raises on any other world.  With
    ``rank``: that rank's abstract view."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if rank is not None:
        return make_mesh(shape, axes, rank=rank)
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the default group has "
                         f"{world}")
    return make_mesh(shape, axes)


def make_debug_mesh(*, data: int = 2, model: int = 2,
                    pod: int | None = None, rank: int | None = None) -> Mesh:
    """A small mesh for tests: (data, model), or (pod, data, model); with
    ``rank``, that rank's abstract view."""
    if pod is not None:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         rank=rank)
    return make_mesh((data, model), ("data", "model"), rank=rank)


def data_axes(mesh) -> tuple[str, ...]:
    """The worker/batch axes: ("data",) or ("pod", "data")."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def data_size(mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= mesh.shape[a]
    return out


def model_size(mesh) -> int:
    return mesh.shape["model"]
