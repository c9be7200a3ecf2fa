"""The dry run against real runs, on the CPU's gloo ranks.

ONE spawn of 4 rank processes builds the (2, 2) ("data", "model") mesh
and, on every rank, runs each case's step for real under
``FlopCounterMode`` and then the dry run of the same step on that rank's
abstract view of the mesh, on fake "cpu" tensors
(``tests/torch_dryrun_ranks.py``): reduced minitron-4b's group step in
both variants (k = 4, 2 microbatches), its prefill at T = 16 |model|
(sequence-parallel) and at T = 8 (below the threshold) and a decode
step, and reduced granite (capacity factor 8.0)'s prefill and decode.
The dry run must give exactly the real run's collectives by kind (calls,
``result_bytes``, ``wire_bytes``), the bytes received by group, and the
dot FLOPs.  A planted fault must fail: the layout's blocked-sum gather
taken back to a direct ``dist.all_gather``, which the mesh's counts then
miss.  The pod sweep's cells (``repro_torch.sim.sweep``) ride the same
spawn: three train-step cells' group steps at reduced minitron, built
from their ``PodScenario``, and the five microcells at small d, whose
outputs must also equal the unsharded function's run in the parent (the
stale sharded cell's aggregate within phase 6's shard-local tolerance of
the chip check, RTOL / ATOL of max|y|).  The (2, 2, 2) ("pod", "data",
"model") mesh on 8 ranks, and granite's group step, run in the slow tier
(``-m slow``)."""

import pytest
import torch

from repro_torch.launch import ranks
from repro_torch.sim import sweep

import torch_dryrun_ranks


def _train(arch, variant, B, **kw):
    return dict(arch=arch, variant=variant, microbatches=2,
                shape=dict(name="train", seq_len=32, global_batch=B,
                           kind="train"), **kw)


def _serve(arch, kind, T, B):
    return dict(arch=arch, shape=dict(name=f"{kind}{T}", seq_len=T,
                                      global_batch=B, kind=kind))


def _cases(B, rows, archs_train, archs_serve):
    out = [_train(arch, v, B) for arch in archs_train
           for v in ("shard_local", "gathered")]
    for arch in archs_serve:
        out += [_serve(arch, "prefill", 32, rows),
                _serve(arch, "prefill", 8, rows),
                _serve(arch, "decode", 64, 4)]
    return out + [_train("minitron-4b", "shard_local", B,
                         fault="direct_gather")]


# the sweep's cells: three train-step cells at reduced minitron (their
# k = 4, one microbatch) and the five microcells at MICRO_D coordinates
SWEEP_STEPS = ("pod/16x16/minitron-4b/gmom/alie/stealth_then_strike",
               "pod/16x16/minitron-4b/krum/norm_stealth/static",
               "pod/16x16/minitron-4b/int8_gmom/sign_flip/static")
MICROCELLS = (sweep.WIRE_BASELINE_SCENARIO, sweep.WIRE_SIGN_SCENARIO,
              sweep.WIRE_INT8_SCENARIO, sweep.STALE_SHARDED_SCENARIO,
              sweep.STALE_GATHERED_SCENARIO)
MICRO_D = 1 << 12
# phase 6's shard-local tolerance (chip_smoke.RTOL, ATOL) of max|y|
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-5
SWEEP = ([dict(_train("minitron-4b", "shard_local", 16), sweep=name,
               microbatches=1) for name in SWEEP_STEPS]
         + [dict(arch="minitron-4b", sweep=name, d=MICRO_D, seed=23,
                 shape=dict(name="microcell", kind="microcell"))
            for name in MICROCELLS])
SQUARE = _cases(16, 2, ["minitron-4b"], ["minitron-4b",
                                         "granite-moe-1b-a400m"]) + SWEEP
CUBE = _cases(32, 4, ["minitron-4b", "granite-moe-1b-a400m"],
              ["minitron-4b", "granite-moe-1b-a400m"])
SQUARE_SLOW = [_train("granite-moe-1b-a400m", v, 16)
               for v in ("shard_local", "gathered")]


def _spawn(world, shape, axes, cases):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks.run(torch_dryrun_ranks.dry_vs_real, world, shape, axes,
                         cases, timeout=900.0)
    finally:
        torch.set_num_threads(old)


SQUARE_SHAPE = (2, 2)


@pytest.fixture(scope="module")
def square():
    return _spawn(4, SQUARE_SHAPE, ("data", "model"), SQUARE)


def _ids(cases):
    return [c["sweep"].replace("pod/16x16/minitron-4b/", "sweep-")
            if "sweep" in c else
            f"{c['arch']}-{c['shape']['name']}"
            f"{'-' + c['variant'] if 'variant' in c else ''}"
            f"{'-' + c['fault'] if 'fault' in c else ''}" for c in cases]


def _check_outputs(per_rank, i, case):
    """A microcell's outputs on every rank against the unsharded function
    on the whole inputs: a whole consume's aggregate and payload, and the
    gathered stale cell's buffer, equal; the sharded stale cell's buffer
    and ages equal on its column block, its aggregate's block within
    SHARD_RTOL / SHARD_ATOL of max|y|."""
    ps = sweep.get_pod_scenario(case["sweep"])
    want = sweep.run_microcell(
        ps, None, case["d"], case["seed"],
        rc=sweep.capped_rc(ps), device="cpu")
    n = SQUARE_SHAPE[1]
    c = case["d"] // n
    for rank, results in enumerate(per_rank):
        got = results[i]["outputs"]
        sl = slice((rank % n) * c, (rank % n + 1) * c)
        if ps.stale and ps.grad_mode == "sharded":
            assert torch.equal(got["buffer"], want["buffer"][:, sl]), rank
            assert torch.equal(got["age"], want["age"]), rank
            y = want["aggregate"][sl]
            err = (got["aggregate"] - y).abs().max().item()
            assert err <= SHARD_ATOL + SHARD_RTOL * y.abs().max().item(), \
                (rank, err)
            continue
        assert torch.equal(got["aggregate"], want["aggregate"]), rank
        for key in ("payload", "buffer", "age"):
            if key in want:
                w = torch.utils._pytree.tree_leaves(want[key])
                g = torch.utils._pytree.tree_leaves(got[key])
                assert len(g) == len(w) and all(
                    torch.equal(a, b) for a, b in zip(g, w)), (rank, key)


def _check(per_rank, i, case):
    for rank, results in enumerate(per_rank):
        res = results[i]
        if case.get("fault"):
            # the real run's gathers went around the mesh: the counts of
            # the same step without the fault (case 0) have more
            clean = results[0]["dry"]["kinds"]["all_gather"]
            got = res["real"]["kinds"]["all_gather"]
            assert got["calls"] < clean["calls"], rank
            assert res["real"]["flops"] == results[0]["real"]["flops"]
            continue
        assert res["dry"]["kinds"] == res["real"]["kinds"], rank
        assert res["dry"]["groups"] == res["real"]["groups"], rank
        assert res["dry"]["flops"] == res["real"]["flops"], rank
        if "d" in case:
            # the wire is one gather of the payload; a stale cell gathers
            # its fresh block whole or its blocked sums' partials
            assert res["real"]["kinds"]["all_gather"]["calls"] >= 1, rank
            continue
        assert res["real"]["flops"] > 0
        if "sweep" in case:
            assert res["real"]["kinds"]["psum_scatter"]["calls"] > 0
            continue
        if case["shape"]["kind"] == "train":
            # the real Weiszfeld loop ran to its cap, where the dry run's
            # stop lies
            assert res["reads"] == torch_dryrun_ranks.train_rc(4) \
                .gmom_max_iters
            assert res["real"]["kinds"]["psum_scatter"]["calls"] > 0


@pytest.mark.parametrize("i", range(len(SQUARE)), ids=_ids(SQUARE))
def test_dry_run_counts_equal_the_real_run_2x2(square, i):
    _check(square, i, SQUARE[i])
    if "d" in SQUARE[i]:
        _check_outputs(square, i, SQUARE[i])


@pytest.mark.slow
def test_dry_run_counts_equal_the_real_run_2x2x2():
    per_rank = _spawn(8, (2, 2, 2), ("pod", "data", "model"), CUBE)
    for i, case in enumerate(CUBE):
        _check(per_rank, i, case)


@pytest.mark.slow
def test_dry_run_counts_equal_the_real_run_granite_step():
    per_rank = _spawn(4, (2, 2), ("data", "model"), SQUARE_SLOW)
    for i, case in enumerate(SQUARE_SLOW):
        _check(per_rank, i, case)
