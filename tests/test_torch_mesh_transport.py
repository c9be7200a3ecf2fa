"""The model mesh's local transport (``meshctx._Arena``) in one process.

The ranks of ``launch.ranks`` exchange a mesh's collectives through a
file mapped in their temporary directory.  Here one thread a rank drives
an arena each on one file, with slots a few bytes wide, so that a payload
takes many rounds: the gathered rows and the exchanged blocks must be the
bytes the ranks put in, in rank order, as ``dist.all_gather`` and
``dist.all_to_all_single`` give them.  The mesh tests on rank processes
(tests/test_torch_mesh*.py) run every collective of the models through
it."""

import threading

import numpy as np
import pytest
import torch

from repro_torch.models import meshctx


def _run(n, body, tmp_path, slot):
    """``body(arena, r)`` on n threads, one arena each on one file ->
    the results in rank order."""
    ranks = tuple(range(n))
    arenas = [meshctx._Arena(str(tmp_path), ranks, r) for r in ranks]
    for a in arenas:
        a.SLOT = slot
    out, errors = [None] * n, []

    def go(r):
        try:
            out[r] = body(arenas[r], r)
        except Exception as e:                    # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=go, args=(r,)) for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


def _payload(r, nbytes, call):
    rng = np.random.default_rng(1000 * r + call)
    return torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8))


@pytest.mark.parametrize("n,nbytes,slot", [(2, 0, 64), (2, 1, 64),
                                           (3, 200, 64), (4, 4096, 4096),
                                           (4, 1000, 96)])
def test_all_gather_gives_every_rank_the_rows_in_order(tmp_path, n, nbytes,
                                                       slot):
    calls = 3

    def body(arena, r):
        return [arena.all_gather(_payload(r, nbytes, c)) for c in range(calls)]
    got = _run(n, body, tmp_path, slot)
    for c in range(calls):
        want = torch.stack([_payload(j, nbytes, c) for j in range(n)])
        for r in range(n):
            assert torch.equal(got[r][c], want)


@pytest.mark.parametrize("n,block,slot", [(2, 0, 64), (2, 5, 64),
                                          (3, 100, 64), (4, 33, 32)])
def test_all_to_all_gives_each_rank_its_blocks_in_order(tmp_path, n, block,
                                                       slot):
    calls = 3

    def body(arena, r):
        return [arena.all_to_all(_payload(r, n * block, c))
                for c in range(calls)]
    got = _run(n, body, tmp_path, slot)
    for c in range(calls):
        sent = [_payload(j, n * block, c).view(n, block) for j in range(n)]
        for r in range(n):
            want = torch.cat([sent[j][r] for j in range(n)])
            assert torch.equal(got[r][c], want)


def test_a_rank_that_never_comes_times_out(tmp_path):
    arena = meshctx._Arena(str(tmp_path), (0, 1), 0)
    arena.WAIT_S = 0.2
    with pytest.raises(TimeoutError, match="still below round 1"):
        arena.all_gather(torch.zeros(8, dtype=torch.uint8))
