"""Worker -> batch grouping for the geometric median of means.

The paper (Algorithm 2, step 1) fixes the partition up-front: the l-th batch
is workers {(l-1)b+1, ..., lb} with b = m/k.  Because the Byzantine set B_t
may change every round but the partition is fixed, at most q batches are
contaminated each round regardless of which workers are faulty.

We also provide strided and seeded-permutation partitions (ablations): the
guarantee is identical for any *fixed* partition, but a fresh random partition
per round is NOT safe against the paper's omniscient adversary (it observes
the server's random bits), so reseeding per-round is deliberately not offered.

Beyond the paper, ``k`` need not divide ``m``: when it does not, batches get
near-even sizes (the first ``m % k`` batches take one extra worker).  The
fixed-partition tolerance argument only needs *some* fixed partition into k
groups, so the guarantee is unchanged; the paper's experimental configuration
m=50, k=11 is exactly this case.  ``assignment_matrix`` exposes the partition
as a dense {0,1} (k, m) membership matrix so batch means can be computed as a
single matmul — the form the plain round aggregate consumes; the CUDA round
kernel (``repro_torch.kernels.geomed.round``) takes the same partition as
CSR member lists (``batch_members_csr``).

A plain copy of ``repro.core.grouping`` (the port imports nothing from
``repro``), plus ``batch_members_csr``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grouping:
    """Static worker->batch assignment. ``perm[w]`` is the slot of worker w;
    ordering workers by slot and splitting at the cumulative ``batch_sizes``
    boundaries yields the batches (for even groupings this is exactly the
    reshape-to-(k, b) view)."""
    num_workers: int
    num_batches: int
    perm: tuple[int, ...]   # length m, a permutation of range(m)

    @property
    def is_even(self) -> bool:
        return self.num_workers % self.num_batches == 0

    @property
    def batch_size(self) -> int:
        """Workers per batch — only defined for even groupings (k | m)."""
        if not self.is_even:
            raise ValueError(
                f"uneven grouping (m={self.num_workers}, k={self.num_batches})"
                " has no single batch_size; use batch_sizes")
        return self.num_workers // self.num_batches

    @property
    def batch_sizes(self) -> tuple[int, ...]:
        """Per-batch worker counts; near-even when k does not divide m."""
        base, rem = divmod(self.num_workers, self.num_batches)
        return tuple(base + 1 if l < rem else base
                     for l in range(self.num_batches))

    def batches(self) -> list[list[int]]:
        # perm maps worker -> slot; batches are contiguous slot ranges, so
        # invert it (slot -> worker) before splitting at the boundaries.
        inv = np.argsort(self.perm)
        out, start = [], 0
        for size in self.batch_sizes:
            out.append([int(inv[start + j]) for j in range(size)])
            start += size
        return out


def make_grouping(num_workers: int, num_batches: int, *,
                  scheme: str = "contiguous", seed: int = 0) -> Grouping:
    if num_batches < 1 or num_batches > num_workers:
        raise ValueError(
            f"num_batches={num_batches} must be in [1, m={num_workers}]")
    if scheme == "contiguous":          # paper Algorithm 2
        perm = tuple(range(num_workers))
    elif scheme == "strided":
        # worker w goes to batch w % k; stable order within batch.
        order = sorted(range(num_workers), key=lambda w: (w % num_batches, w))
        perm = tuple(int(np.argsort(order)[w]) for w in range(num_workers))
    elif scheme == "seeded":
        rng = np.random.default_rng(seed)
        order = rng.permutation(num_workers)
        perm = tuple(int(np.argsort(order)[w]) for w in range(num_workers))
    else:
        raise ValueError(f"unknown grouping scheme {scheme!r}")
    return Grouping(num_workers=num_workers, num_batches=num_batches,
                    perm=perm)


def worker_batch_ids(grouping: Grouping) -> np.ndarray:
    """(m,) int array: ``worker_batch_ids(g)[w]`` is the batch worker w
    belongs to.  The per-worker (row-wise) view of ``assignment_matrix`` —
    the form selection-style rules (``norm_filter_gmom``) use to rescale a
    worker's contribution to its batch mean without materializing S."""
    ids = np.zeros((grouping.num_workers,), np.int64)
    for l, members in enumerate(grouping.batches()):
        ids[members] = l
    return ids


def assignment_matrix(grouping: Grouping) -> np.ndarray:
    """Dense {0,1} membership matrix S of shape (k, m): S[l, w] = 1 iff
    worker w belongs to batch l.  Batch sums are ``S @ G`` for stacked
    gradients G (m, d); dividing row l by ``batch_sizes[l]`` gives the batch
    means.
    """
    s = np.zeros((grouping.num_batches, grouping.num_workers), np.float32)
    for l, members in enumerate(grouping.batches()):
        s[l, members] = 1.0
    return s


def choose_num_batches(num_workers: int, num_byzantine: int, *,
                       epsilon: float = 0.1,
                       prefer_even: bool = True) -> int:
    """The paper's canonical k (Remark 1): k=1 when q=0, else the smallest
    divisor of m with k >= 2(1+epsilon)q (tolerance requires 2(1+eps)q<=k).

    ``prefer_even=True`` (the default, and the historical behavior every
    golden trace is recorded on) keeps the paper's exact-split assumption
    b = m/k, which can overshoot: m=50, q=5 needs k >= 11 but the smallest
    divisor is 25.  ``prefer_even=False`` returns the smallest k >= need
    outright — the paper's own experimental geometry (m=50, k=11), with
    near-even uneven batches handled by ``make_grouping``/the fused round
    kernel's membership matmul.  Callers wanting a specific k (e.g. the
    paper's 11) pass ``num_batches`` explicitly.
    """
    if num_byzantine == 0:
        return 1
    need = 2.0 * (1.0 + epsilon) * num_byzantine
    for k in range(1, num_workers + 1):
        if k >= need and (num_workers % k == 0 or not prefer_even):
            return k
    raise ValueError(
        f"cannot tolerate q={num_byzantine} byzantine of m={num_workers}: "
        f"need k >= {need:.1f} <= m")


def batch_members_csr(grouping: Grouping) -> tuple[np.ndarray, np.ndarray]:
    """The partition as CSR member lists: int32 ``offsets`` (k+1,) and
    ``members`` (m,), each batch's workers in ascending order — the order
    in which the CUDA round kernel sums a batch."""
    batches = [sorted(b) for b in grouping.batches()]
    offsets = np.zeros((grouping.num_batches + 1,), np.int32)
    offsets[1:] = np.cumsum([len(b) for b in batches])
    members = np.asarray([w for b in batches for w in b], np.int32)
    return offsets, members
