"""Layer B, RV204: the CUDA round kernel's launch budget (the port's twin
of ``repro.verify.vmem``: the card offers shared memory and SMs where the
TPU core offers VMEM).

Three invariants, checked on the CPU without building or running the
kernel, from ``kernels/geomed/round.py``'s plan and the constants of the
CUDA sources (read from their text: ``kOnepassStages`` lives only in
``linreg_round.cu``):

1. **The plan fits the card.**  For every d that ``linreg_route(d)`` sends
   to the one-pass front, its TMA ring (``kOnepassStages`` stages of
   ``onepass_rows_per_stage(d)`` rows of 4·d bytes, plus the block's
   static shared memory) fits the H100's opt-in shared memory a block,
   and the Python plan's rows a stage are the C plan's.  The persistent
   grid ``persistent_blocks(d, ., RECKONED_SMS)`` gives every block at
   least one of ``block_tiles``' tiles, and ``scratch_bytes`` holds the
   (k, d) slab exactly when some block walks more than one tile.
2. **The dispatcher agrees with the kernels' own guards** on a grid
   spanning both sides of each boundary: ``resolve_round_backend``'s
   ``fits`` (k <= ``MAX_BATCHES``) against the C entries' refusal of k
   outside [1, ``kMaxBatches``], and ``linreg_route(d)`` against the
   one-pass guard (d % 4 == 0, d <= ``kOnepassMaxD``).
3. **The paper's shapes take the kernel**: m = 50 workers, k in {11, 25}
   batches, d = 100 resolve to ``"fused"`` on a CUDA route, and their
   persistent grid fits in one wave.

On the card, :func:`check_library` holds the built libraries to the
same plan: ``*_max_batches()`` equals ``MAX_BATCHES``, ``*_blocks_per_sm(k)``
is positive for k = 1..``MAX_BATCHES`` and refused beyond, and the
one-pass ring fits the device's ``shared_memory_per_block_optin``.
"""

from __future__ import annotations

import itertools
import re
from pathlib import Path

from repro_torch.verify.rules import Finding

# The H100's shared memory a block may opt in to: 227 KB (NVIDIA Hopper
# Tuning Guide, "Shared Memory": 228 KB an SM, of which a block can use up
# to 227 KB).
SMEM_OPTIN_BYTES = 227 * 1024

GRID_K = (1, 11, 25, 64, 65)
GRID_D = (100, 8192, 8196, 25557032)
PAPER_SHAPES = ((50, 11, 100), (50, 25, 100))
# d of the persistent grid's tile check: one tile, a partial tile, a wave
# of tiles, more tiles than blocks
GRID_TILES_D = (1, 100, 256, 257, 33792, 33793, 25557032)

_PATH = "src/repro_torch/kernels/geomed/round.py"
_ANCHOR = "<kernel:gmom_round>"


def _round_module():
    from repro_torch.kernels.geomed import round as round_mod
    return round_mod


def _csrc() -> Path:
    return Path(_round_module().SOURCE).parent


def source_constants() -> dict[str, int]:
    """The integer ``constexpr`` constants of the round kernels' sources
    (``gmom_common.cuh``, ``gmom_round.cuh``, ``linreg_round.cu``),
    evaluated in order (each may name earlier ones)."""
    values: dict[str, int] = {}
    pat = re.compile(r"constexpr\s+int\s+(k\w+)\s*=\s*([^;]+);")
    for name in ("gmom_common.cuh", "gmom_round.cuh", "linreg_round.cu"):
        text = (_csrc() / name).read_text()
        for const, expr in pat.findall(text):
            expr = re.sub(r"//.*", "", expr).strip()
            try:
                values[const] = int(eval(expr, {"__builtins__": {}},
                                         dict(values)))
            except Exception:  # noqa: BLE001  (a non-integer expression)
                continue
    return values


def _c_rows_per_stage(d: int, c: dict) -> int:
    """``onepass_rows_per_stage`` of linreg_round.cu, from its constants."""
    need = (d // 4 + c["kOnepassChunks"] - 1) // c["kOnepassChunks"]
    tpr = 32
    while tpr < need:
        tpr *= 2
    groups = c["kOnepassThreads"] // tpr
    fit = c["kOnepassStageBytes"] // (4 * d) // groups * groups
    return fit if fit > groups else groups


def onepass_ring_bytes(d: int, c: dict) -> int:
    """Shared memory of one one-pass block: the dynamic ring and the
    static mbarriers and reduction slots."""
    ring = c["kOnepassStages"] * _c_rows_per_stage(d, c) * d * 4
    static = 8 * c["kOnepassStages"] + 4 * 2 * (c["kOnepassThreads"] // 32)
    return ring + static


def _c_onepass(d: int, c: dict) -> bool:
    return d % 4 == 0 and d <= c["kOnepassMaxD"]


def _c_takes_k(k: int, c: dict) -> bool:
    return 1 <= k <= c["kMaxBatches"]


def _finding(message: str) -> Finding:
    return Finding(rule="RV204", path=_ANCHOR, line=0, col=0,
                   message=message)


def check_smem_budget() -> list[Finding]:
    """RV204's CPU checks (the module docstring's invariants 1-3)."""
    from repro_torch.core.aggregators import resolve_round_backend
    r = _round_module()
    c = source_constants()
    findings: list[Finding] = []

    # 1. the plan fits the card
    for py, cname in (("MAX_BATCHES", "kMaxBatches"), ("TILE", "kTile"),
                      ("ONEPASS_THREADS", "kOnepassThreads"),
                      ("ONEPASS_CHUNKS", "kOnepassChunks"),
                      ("ONEPASS_STAGE_BYTES", "kOnepassStageBytes"),
                      ("D_ONEPASS", "kOnepassMaxD")):
        if getattr(r, py) != c[cname]:
            findings.append(_finding(
                f"round.{py}={getattr(r, py)} but the CUDA source's "
                f"{cname}={c[cname]}: the plan and the kernel drifted"))
    worst = 0
    for d in range(4, r.D_ONEPASS + 1, 4):
        if r.linreg_route(d) != "one_pass":
            continue
        rows_py, rows_c = r.onepass_rows_per_stage(d), _c_rows_per_stage(d, c)
        if rows_py != rows_c:
            findings.append(_finding(
                f"onepass_rows_per_stage({d}) is {rows_py} in round.py and "
                f"{rows_c} in linreg_round.cu: the formulas drifted"))
            break
        need = onepass_ring_bytes(d, c)
        worst = max(worst, need)
        if need > SMEM_OPTIN_BYTES:
            findings.append(_finding(
                f"the one-pass ring at d={d} needs {need} B of shared "
                f"memory a block, over the H100's {SMEM_OPTIN_BYTES} B"))
            break
    for d, k in itertools.product(GRID_TILES_D, (1, 11, 64)):
        nb = r.persistent_blocks(d, 1, r.RECKONED_SMS)
        tiles = r.block_tiles(d, nb)
        n_tiles = -(-d // r.TILE)
        walked = sorted(t for blk in tiles for t in blk)
        if len(tiles) != nb or any(not blk for blk in tiles) or \
                nb > r.RECKONED_SMS or walked != sorted(
                    (t * r.TILE, min(d, (t + 1) * r.TILE))
                    for t in range(n_tiles)):
            findings.append(_finding(
                f"persistent_blocks({d}, 1, {r.RECKONED_SMS}) = {nb} and "
                f"block_tiles disagree: a block without a tile, a tile "
                f"walked twice or missed, or more blocks than SMs"))
            continue
        slab = max(len(blk) for blk in tiles) > 1
        want = 4 * ((k * n_tiles * r.TILE if slab else 0)
                    + 2 * nb * (k + 1))
        if r.scratch_bytes(k, d) != want:
            findings.append(_finding(
                f"scratch_bytes({k}, {d}) = {r.scratch_bytes(k, d)} B but "
                f"the grid of {nb} blocks needs {want} B (the (k, d) slab "
                f"{'with' if slab else 'without'} a block of several "
                f"tiles)"))

    # 2. the dispatcher agrees with the kernels' guards
    for k, d in itertools.product(GRID_K, GRID_D):
        fits = resolve_round_backend("auto", num_batches=k,
                                     device="cuda") == "fused"
        if fits != _c_takes_k(k, c):
            findings.append(_finding(
                f"resolve_round_backend and the kernels' guard disagree at "
                f"(k={k}, d={d}): the dispatcher says "
                f"{'fused' if fits else 'reference'}, the C entry "
                f"{'takes' if _c_takes_k(k, c) else 'refuses'} k (its "
                f"kMaxBatches={c['kMaxBatches']}): the two limits drifted"))
        one_pass = r.linreg_route(d) == "one_pass"
        if one_pass != _c_onepass(d, c):
            findings.append(_finding(
                f"linreg_route({d}) is {r.linreg_route(d)!r} but the "
                f"one-pass guard of linreg_round.cu "
                f"{'takes' if _c_onepass(d, c) else 'refuses'} d: the two "
                f"limits drifted"))

    # 3. the paper's shapes take the kernel
    for m, k, d in PAPER_SHAPES:
        backend = resolve_round_backend("auto", num_batches=k,
                                        device="cuda")
        nb = r.persistent_blocks(d, 1, r.RECKONED_SMS)
        if backend != "fused" or nb > r.RECKONED_SMS:
            findings.append(_finding(
                f"paper-scale shape (m={m}, k={k}, d={d}) resolves to "
                f"{backend!r} with a grid of {nb} blocks: it must take the "
                f"fused kernel in one wave of {r.RECKONED_SMS} SMs"))
    return findings


def check_library(device=None) -> list[Finding]:
    """RV204 on the card: the built round libraries against the plan (the
    module docstring).  Builds them on first use; needs CUDA."""
    import torch
    r = _round_module()
    c = source_constants()
    findings: list[Finding] = []
    optin = torch.cuda.get_device_properties(
        device or 0).shared_memory_per_block_optin
    for lib, prefix in ((r._library(), "gmom_round"),
                        (r._linreg_library(), "gmom_linreg")):
        got = getattr(lib, f"{prefix}_max_batches")()
        if got != r.MAX_BATCHES:
            findings.append(_finding(
                f"{prefix}_max_batches() = {got} but round.MAX_BATCHES = "
                f"{r.MAX_BATCHES}"))
        per_sm = getattr(lib, f"{prefix}_blocks_per_sm")
        bad = [k for k in range(1, r.MAX_BATCHES + 1) if per_sm(k) <= 0]
        if bad:
            findings.append(_finding(
                f"{prefix}_blocks_per_sm(k) fits no block at k={bad}, "
                f"which the dispatcher sends to the kernel"))
        if per_sm(r.MAX_BATCHES + 1) > 0:
            findings.append(_finding(
                f"{prefix}_blocks_per_sm({r.MAX_BATCHES + 1}) takes k past "
                f"round.MAX_BATCHES: the guard and the plan drifted"))
    worst = max(onepass_ring_bytes(d, c)
                for d in range(4, r.D_ONEPASS + 1, 4)
                if r.linreg_route(d) == "one_pass")
    if worst > optin:
        findings.append(_finding(
            f"the one-pass ring needs up to {worst} B of shared memory a "
            f"block, over the device's opt-in {optin} B"))
    return findings
