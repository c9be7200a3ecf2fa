"""Roofline analysis of a dry run's trace (port of
``repro.roofline.analysis``).

Terms per (arch × shape × mesh), from one rank's traced step
(``launch.dryrun``; the counts are ``roofline.counter``'s and the mesh's
own, so every term is per rank):

    compute_term    = per-rank dot FLOPs / PEAK_FLOPS
    memory_term     = per-rank bytes accessed / HBM_BW
    collective_term = sum over the rank's groups of the bytes its
                      transport received there / that group's slowest link

The reference's per-device collective bytes are the collectives' result
bytes (``collective_bytes_per_device``, kept for comparison); the port's
transport moves other bytes (a psum gathers its n parts and sums them in
rank order, about n times the all-reduce's result), so the collective
term reads the bytes received (``wire_bytes_per_device``).

Hardware constants: an NVIDIA H100 SXM in a DGX H100 node; none is a TPU
figure.
"""

from __future__ import annotations

import dataclasses
import json

# bf16 dense tensor-core peak, FLOP/s (NVIDIA H100 SXM data sheet; the
# figure PERF.md's flash-attention bound uses)
PEAK_FLOPS = 989e12
# HBM3, bytes/s (NVIDIA H100 SXM data sheet)
HBM_BW = 3.35e12
# NVLink 4 within a node, bytes/s per direction (900 GB/s bidirectional;
# NVIDIA H100 SXM data sheet)
NVLINK_BW = 450e9
# between nodes, bytes/s: one 400 Gb/s ConnectX-7 port a GPU (the DGX H100
# system's layout)
NODE_BW = 50e9
# GPUs of a node; ranks go row-major over the mesh, 8 consecutive ranks a
# node
RANKS_PER_NODE = 8


def link_bandwidth(ranks) -> float:
    """The slowest link a group of ``ranks`` crosses: NVLink within one
    node, the node's network port across nodes."""
    nodes = {r // RANKS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NODE_BW


@dataclasses.dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    step: str
    flops_per_device: float           # dot FLOPs of one rank's step
    bytes_per_device: float           # bytes its ops read and wrote
    collective_bytes_per_device: float  # result bytes (the reference's)
    collective_breakdown: dict        # kind -> calls, result_bytes, wire_bytes
    peak_memory_bytes: float | None   # live device storage, inputs included
    model_flops_global: float
    num_chips: int
    # no XLA in the port: its uncorrected cost_analysis numbers are 0
    xla_flops_raw: float = 0.0
    xla_bytes_raw: float = 0.0
    rank: int = 0
    wire_bytes_per_device: float = 0.0
    # "axis,axis" -> {"wire_bytes", "bandwidth"}: the rank's groups
    collective_groups: dict = dataclasses.field(default_factory=dict)
    params_bytes: float = 0.0         # the rank's storage blocks
    opt_state_bytes: float = 0.0
    inputs_bytes: float = 0.0         # batch or decode state block
    trace_seconds: float = 0.0

    @property
    def compute_term(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_term(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_term(self) -> float:
        return sum(g["wire_bytes"] / g["bandwidth"]
                   for g in self.collective_groups.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips × per-rank dot FLOPs): how much of the
        traced compute is 'useful' (catches remat and redundant work);
        > 1 where the step does less than the analytic count."""
        total = self.flops_per_device * self.num_chips
        return self.model_flops_global / total if total else float("nan")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_term=self.compute_term,
                 memory_term=self.memory_term,
                 collective_term=self.collective_term,
                 bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training (N = active params,
    D = tokens), 2·N·D for inference forward passes."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build_record(*, arch: str, shape, cfg, mesh_name: str, num_chips: int,
                 step: str, counter, mesh, **extra) -> RooflineRecord:
    """The record of one rank's traced step: ``counter`` (a
    ``roofline.counter.Counter``) the trace's counts, ``mesh`` its
    abstract mesh, whose ``stats`` hold the step's collectives."""
    kinds = {k: dict(v) for k, v in mesh.stats["kinds"].items()}
    groups = {key: {"wire_bytes": n, "bandwidth": link_bandwidth(
        mesh.group(tuple(key.split(",")))[1])}
        for key, n in mesh.stats["groups"].items()}
    return RooflineRecord(
        arch=arch, shape=shape.name, mesh=mesh_name, step=step,
        flops_per_device=float(counter.dot_flops),
        bytes_per_device=float(counter.bytes_accessed),
        collective_bytes_per_device=float(sum(
            v["result_bytes"] for v in kinds.values())),
        collective_breakdown=kinds,
        peak_memory_bytes=float(counter.peak_bytes),
        model_flops_global=model_flops(cfg, shape), num_chips=num_chips,
        rank=mesh.rank,
        wire_bytes_per_device=float(sum(
            v["wire_bytes"] for v in kinds.values())),
        collective_groups=groups, **extra)


def sweep_entry(record: RooflineRecord, *, scenario: str) -> dict:
    """Per-scenario collective-cost record entry for a pod sweep: the
    JSON-stable projection of a RooflineRecord keyed by scenario name."""
    return {
        "scenario": scenario,
        "arch": record.arch,
        "shape": record.shape,
        "mesh": record.mesh,
        "step": record.step,
        "num_chips": record.num_chips,
        "collective_bytes_per_device": record.collective_bytes_per_device,
        "collective_breakdown": dict(record.collective_breakdown),
        "peak_memory_bytes": record.peak_memory_bytes,
        "flops_per_device": record.flops_per_device,
        "bytes_per_device": record.bytes_per_device,
        "collective_term": record.collective_term,
        "bottleneck": record.bottleneck,
    }


def format_table(records: list[RooflineRecord]) -> str:
    header = ("| arch | shape | mesh | step | compute s | memory s | "
              "collective s | bottleneck | useful-FLOPs | peak GiB/chip |")
    sep = "|" + "---|" * 10
    rows = [header, sep]
    for r in records:
        peak = (f"{r.peak_memory_bytes / 2**30:.2f}"
                if r.peak_memory_bytes else "n/a")
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.step} "
            f"| {r.compute_term:.3e} | {r.memory_term:.3e} "
            f"| {r.collective_term:.3e} | {r.bottleneck} "
            f"| {r.useful_flops_ratio:.2f} | {peak} |")
    return "\n".join(rows)


def save_records(records: list[RooflineRecord], path: str):
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in records], f, indent=1)


def load_records(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)
