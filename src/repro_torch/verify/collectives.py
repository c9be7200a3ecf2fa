"""What crosses shards, and how big it is: Layer B's measuring stick (port
of ``repro.verify.collectives``).

The reference has two views of one program: its jaxpr (the collectives
the code asked for) and its compiled HLO (those the partitioner added).
The port has no partitioner: each rank runs its own program with the
collectives placed by hand, so its two views are

* **the traced view**: rank 0's program traced on fake tensors on an
  abstract mesh (``models.meshctx.Mesh.abstract``), whose transport logs
  every collective (``Mesh.log_calls``): its kind, mesh axes, received
  shape and dtype, and wire bytes.  The traced graph holds the same
  collectives as nodes of ``repro_torch::mesh_transfer`` (one a call,
  which :func:`graph_transfers` counts);
* **the real view**: the same log taken on real ranks
  (``launch.ranks.run``: gloo on the CPU, the mapped-file transport on
  the card), which must equal the traced one.
"""

from __future__ import annotations

from repro_torch.models.meshctx import CollectiveCall


def key(calls) -> list:
    """The d-independence comparison key: the distinct (kind, shape)
    pairs, sorted (a loop may stop after another number of passes at
    another d; a d-dependent collective changes a shape)."""
    return sorted({(c.kind, tuple(c.shape)) for c in calls})


def as_tuples(calls) -> list[tuple]:
    """A log as plain tuples (what a rank process hands back)."""
    return [tuple(c) for c in calls]


def from_tuples(rows) -> list[CollectiveCall]:
    return [CollectiveCall(kind, tuple(axes), tuple(shape), dtype,
                           int(nbytes))
            for kind, axes, shape, dtype, nbytes in rows]


def total_bytes(calls) -> int:
    return sum(c.wire_bytes for c in calls)


def fmt(calls) -> str:
    return ", ".join(f"{c.kind}{list(c.shape)}:{c.dtype}"
                     for c in calls) or "none"


def graph_transfers(gm) -> int:
    """The number of the abstract mesh's collectives in a traced graph."""
    from repro_torch.verify.influence import op_name
    return sum(1 for n in gm.graph.nodes
               if n.op == "call_function" and op_name(n) == "mesh_transfer")


def diff(traced, real) -> str | None:
    """None when the real log equals the traced one call for call (kind,
    axes, shape, dtype and bytes), else what differs."""
    traced, real = list(traced), list(real)
    if traced == real:
        return None
    if len(traced) != len(real):
        return (f"{len(real)} real collectives against {len(traced)} "
                f"traced ({total_bytes(real)} against "
                f"{total_bytes(traced)} bytes)")
    for i, (t, r) in enumerate(zip(traced, real)):
        if t != r:
            return f"call {i}: real {tuple(r)} against traced {tuple(t)}"
    return None
