"""Decode and short-sequence attention on the port's model mesh
(``models/attention.py`` ``decode_step`` on cache blocks, ``apply`` below
the sequence-parallel threshold; ``models/layers.py``'s SwiGLU psum,
``models/moe.py``'s uncut branch, ``models/mamba.py``'s and
``models/rwkv.py``'s decode on the rank's channels and heads;
``launch/sharding.py`` ``local_decode_state``) against the reference's
own mesh run and the port's one process.

One module-scoped spawn of 4 gloo ranks (``repro_torch.launch.ranks``,
one thread each) builds a (2, 2) and a (1, 4) ("data", "model") mesh over
the same ranks; the rank bodies are tests/torch_mesh_decode_ranks.py.
Beside them run two processes of tests/mesh_decode_reference.py, the
reference's jitted serve and prefill steps on each mesh (8 virtual CPU
devices, Auto axes, the original threefry), and this process runs the
port's one-process decode, prefill, loss and gradients on the same
inputs (the port's init, handed across as numpy).

Each of the six reduced families, float32, B = 4: 16 teacher-forced
decode steps (a prompt of 8 tokens and 8 more; Granite at capacity
factor 8.0, as the reference's EP case runs it), and H2O with a window
of 8 slots, whose ring wraps across the ranks' blocks; the prefill at
T = 8 on (2, 2) and T = 6 on (1, 4) (T % |model| != 0), both below the
threshold of 16 |model|, and H2O's and SeamlessM4T's at T = 16 (16
frames) on (1, 4), whole blocks as long as cut ones (the layout read
from the record ``sharding.local_batch`` keeps with the block); one
group train step of H2O at T = 32 on (1, 4), also whole and as long as
a cut block, against the same step in one process.  Limits: logits at every
step within 1e-5 of max|logits| of the reference's mesh decode and of
one process, the same bits on every model rank; the state's blocks
gathered whole within 1e-5 of one process's state; prefill hidden
states within 1e-5 of the reference's mesh prefill and of one process;
the loss within 1e-5 and every gradient within 1e-4 of its max|g| of
one process; the train step's losses and aggregate norm within 1e-5
and its params within 1e-5 of one process's.  A dense batch that is not
such a block is refused under a mesh.  Rows the data axes do not divide (B = 1
and 3 on (2, 2), each family): whole on every data rank, the decode's logits
and the prefill's hidden states within 1e-5 of the reference's own mesh run
and of one process, the same bits on every rank, and H2O served through
``serve.generate`` at B = 1.  Two planted faults must miss: softmax parts summed
without the global max's rescale, and a Mamba2 decode that hands its
heads the rank's B and C block in place of the gathered channels.
"""

import concurrent.futures
import os
import pickle
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import convert
from repro_torch.launch import ranks, serve, sharding
from repro_torch.models import meshctx, model

import torch_mesh_decode_ranks as dr
import torch_mesh_ranks

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
# name: (arch, overrides)
FAMILIES = {"h2o": ("h2o-danube-3-4b", {}),
            "granite": ("granite-moe-1b-a400m",
                        {"moe_capacity_factor": 8.0}),
            "rwkv6": ("rwkv6-7b", {}),
            "zamba2": ("zamba2-2.7b", {}),
            "seamless": ("seamless-m4t-medium", {}),
            "internvl2": ("internvl2-26b", {})}
DECODE = dict(FAMILIES, h2o_ring=("h2o-danube-3-4b", {"sliding_window": 8}))
MESHES = ("2x2", "1x4")
ROWS, STEPS, PATCHES = 4, 16, 4
PREFILL_T = {"2x2": 8, "1x4": 6}
# H2O and SeamlessM4T at T = 16 (and 16 frames) on (1, 4), and the H2O
# train step at T = 32: whole, yet as long as cut blocks of 64 and 128
BAND_T = 16
TRAIN_T = 32
TRAIN_RC = dict(num_workers=2, aggregator="mean")
DECODE_IDS = [f"{n}/{m}" for n in DECODE for m in MESHES]
PREFILL_IDS = [f"{n}/{m}" for n in FAMILIES for m in MESHES] \
    + ["h2o_band/1x4", "seamless_band/1x4"]
FAULTS = {"no_rescale": "h2o_ring/1x4", "no_gather": "zamba2/1x4"}
GENERATE = {"generate/h2o/2x2": "h2o", "generate/zamba2/1x4": "zamba2",
            "generate/granite/2x2": "granite",
            "generate/h2o/2x2/b1": "h2o"}
# rows the data axes do not divide: whole on every data rank of (2, 2)
WHOLE_ROWS = (1, 3)
WHOLE_IDS = [f"{n}/2x2/b{b}" for n in FAMILIES for b in WHOLE_ROWS]


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs():
    """{name: (cfg, numpy params, tokens (B, S), audio memory or None)}."""
    out = {}
    for i, (name, (arch, ov)) in enumerate(DECODE.items()):
        cfg = dr.cfg_of({"arch": arch, "overrides": ov})
        params = tree_map(lambda t: t.numpy(), model.init(
            i, cfg, device="cpu"))
        rng = np.random.default_rng(300 + i)
        tokens = rng.integers(0, cfg.vocab_size, (ROWS, STEPS))
        memory = None
        if cfg.family == "audio":
            # the decode state's memory of max_len // 4 frames
            memory = rng.standard_normal(
                (ROWS, STEPS // cfg.encoder_seq_divisor, cfg.d_model)
            ).astype(np.float32)
        out[name] = (cfg, params, tokens.astype(np.int64), memory)
    return out


def _prefill_batch(cfg, tokens, T, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": tokens[:, :T], "labels": tokens[:, 1:T + 1]}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (ROWS, PATCHES, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (ROWS, T, cfg.d_model)).astype(np.float32)
    return batch


def _cases(inputs):
    cases = {}
    for name, (cfg, params, tokens, memory) in inputs.items():
        arch, ov = DECODE[name]
        base = dict(arch=arch, overrides=ov, params=params)
        for mesh in MESHES:
            case = dict(base, kind="decode", tokens=tokens, max_len=STEPS,
                        mesh=mesh, family=name)
            if memory is not None:
                case["memory"] = memory
            cases[f"decode/{name}/{mesh}"] = case
            if name in FAMILIES:
                cases[f"prefill/{name}/{mesh}"] = dict(
                    base, kind="prefill", mesh=mesh, family=name,
                    batch=_prefill_batch(cfg, tokens, PREFILL_T[mesh],
                                         seed=400 + len(cases)))
    for name in ("h2o", "seamless"):
        cfg, params, tokens, _ = inputs[name]
        cases[f"prefill/{name}_band/1x4"] = dict(
            arch=DECODE[name][0], overrides={}, params=params,
            kind="prefill", mesh="1x4", family=name,
            batch=_prefill_batch(cfg, tokens, BAND_T, seed=500))
    cfg, params = inputs["h2o"][:2]
    rng = np.random.default_rng(600)
    tok = rng.integers(0, cfg.vocab_size, (2, ROWS // 2, TRAIN_T + 1))
    cases["train/h2o_band/1x4"] = dict(
        arch=DECODE["h2o"][0], overrides={}, params=params, kind="train",
        mesh="1x4", family="h2o", rc=TRAIN_RC, lr=0.1, seed=7,
        batch={"tokens": tok[..., :-1], "labels": tok[..., 1:]})
    for fault, cid in FAULTS.items():
        cases[f"fault/{fault}"] = dict(cases[f"decode/{cid}"], fault=fault)
    for cid, name in GENERATE.items():
        arch, ov = DECODE[name]
        rows = int(cid.split("/b")[1]) if "/b" in cid else ROWS
        cases[cid] = dict(arch=arch, overrides=ov, kind="generate",
                          family=name,
                          params=inputs[name][1], mesh=cid.split("/")[2],
                          prompts=inputs[name][2][:rows, :8], new_tokens=8)
    for wid in WHOLE_IDS:
        name, b = wid.split("/")[0], int(wid.split("/b")[1])
        decode = cases[f"decode/{name}/2x2"]
        cases[f"decode/{wid}"] = dict(decode, tokens=decode["tokens"][:b])
        if "memory" in decode:
            cases[f"decode/{wid}"]["memory"] = decode["memory"][:b]
        prefill = cases[f"prefill/{name}/2x2"]
        cases[f"prefill/{wid}"] = dict(prefill, batch={
            k: v[:b] for k, v in prefill["batch"].items()})
    return cases


def _one_process(inputs, cases):
    """The port's one process: {case id: logits and the final state, or
    hidden states, loss and flat gradients, or generated tokens}."""
    out = {}
    for cid, case in cases.items():
        if cid.startswith("fault/"):
            continue
        cfg, npp = inputs[case["family"]][0], case["params"]
        params = convert.lm_params_from_numpy(cfg, npp, "cpu")
        if case["kind"] == "decode":
            if case["mesh"] != MESHES[0]:
                continue
            state = dr.decode_state(cfg, case)
            logits = dr.decode_logits(cfg, params, state,
                                      torch.as_tensor(case["tokens"]))
            out[cid] = (logits, state)
        elif case["kind"] == "train":
            out[cid] = dr.train_step(case)
        elif case["kind"] == "prefill":
            batch = dr.as_batch(case["batch"])
            with torch.no_grad():
                h = model.prefill(params, cfg, batch)
            if cid.endswith(tuple(f"/b{b}" for b in WHOLE_ROWS)):
                out[cid] = (h,)
                continue
            params = tree_map(lambda t: t.requires_grad_(), params)
            loss = model.loss_fn(params, batch, cfg)
            loss.backward()
            out[cid] = (h, float(loss.detach()),
                        _flat(tree_map(lambda t: t.grad, params)))
        else:
            out[cid] = serve.generate(
                params, cfg, torch.as_tensor(case["prompts"]),
                case["new_tokens"])[0]
    return out


def _reference(cases, tmp):
    """Start the reference's mesh run on each mesh: {mesh: (process, out
    file)}."""
    runs = {}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"),
         os.environ.get("PYTHONPATH", "")]))
    for mesh in MESHES:
        mine = {cid: c for cid, c in cases.items()
                if c["kind"] in ("decode", "prefill") and c["mesh"] == mesh
                and not cid.startswith("fault/")}
        src, out = (os.path.join(tmp, f"{mesh}.{x}.pkl")
                    for x in ("in", "out"))
        with open(src, "wb") as f:
            pickle.dump(mine, f)
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "mesh_decode_reference.py"),
             src, out, mesh], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        runs[mesh] = (proc, out)
    return runs


@pytest.fixture(scope="module")
def runs():
    """(cases, the ranks' results in rank order, the reference's results,
    the port's one-process results)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs()
        cases = _cases(inputs)
        with tempfile.TemporaryDirectory() as tmp, \
                concurrent.futures.ThreadPoolExecutor(1) as pool:
            refs = _reference(cases, tmp)
            spawned = pool.submit(ranks.run, dr.run_cases, WORLD, cases,
                                  timeout=600.0)
            one = _one_process(inputs, cases)
            per_rank = spawned.result()
            reference = {}
            for mesh, (proc, out) in refs.items():
                log, _ = proc.communicate(timeout=600)
                assert proc.returncode == 0, log[-4000:]
                with open(out, "rb") as f:
                    reference.update(pickle.load(f))
    finally:
        torch.set_num_threads(threads)
    return cases, per_rank, reference, one


# ---------------------------------------------------------------------------
# helpers

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v.detach().numpy()
    return out


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def _rows(per_rank, cid, key, mesh):
    """The whole (B, ...) result from the ranks' rows: rank d |model| + m
    holds data row block d; the model ranks' copies must be the same
    bits."""
    nd, nm = dr.MESHES[mesh][0]
    rows = []
    for d in range(nd):
        parts = [per_rank[d * nm + m][cid][key] for m in range(nm)]
        assert all(torch.equal(p, parts[0]) for p in parts), cid
        rows.append(parts[0])
    return torch.cat(rows, 0).numpy()


def _one_decode(one, name):
    return one[f"decode/{name}/{MESHES[0]}"]


def _whole(per_rank, cid, key):
    """A result every rank holds whole (rows the data axes do not divide):
    the same bits on every rank."""
    parts = [res[cid][key] for res in per_rank]
    assert all(torch.equal(p, parts[0]) for p in parts), cid
    return parts[0].numpy()


# ---------------------------------------------------------------------------
# decode

@pytest.mark.parametrize("cid", DECODE_IDS)
def test_decode_matches_the_reference_mesh_decode(runs, cid):
    _, per_rank, reference, _ = runs
    got = _rows(per_rank, f"decode/{cid}", "logits", cid.split("/")[1])
    want = reference[f"decode/{cid}"]
    assert np.isfinite(got).all()
    errs = [_rel_err(got[:, t], want[:, t]) for t in range(STEPS)]
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_decode_matches_one_process(runs, cid):
    _, per_rank, _, one = runs
    name, mesh = cid.split("/")
    got = _rows(per_rank, f"decode/{cid}", "logits", mesh)
    want = _one_decode(one, name)[0].numpy()
    errs = [_rel_err(got[:, t], want[:, t]) for t in range(STEPS)]
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_decode_state_blocks_gather_to_one_process(runs, cid):
    """Every leaf of the state after the 16 steps (the caches' slots
    written by their owning rank, the recurrent states' channels and
    heads), its blocks gathered whole, within 1e-5 of one process's."""
    _, per_rank, _, one = runs
    got = tree_leaves(per_rank[0][f"decode/{cid}"]["state"])
    want = tree_leaves(_one_decode(one, cid.split("/")[0])[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w.numpy()) <= 1e-5


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_miss(runs, fault):
    """The softmax parts summed without the global max's rescale (H2O's
    ring), and a Mamba2 decode whose heads take the rank's B and C block
    as every channel: finite logits that miss one process's by a
    hundred times the limit."""
    _, per_rank, _, one = runs
    cid = FAULTS[fault]
    got = _rows(per_rank, f"fault/{fault}", "logits", cid.split("/")[1])
    want = _one_decode(one, cid.split("/")[0])[0].numpy()
    assert np.isfinite(got).all()
    assert _rel_err(got, want) > 100 * 1e-5


@pytest.mark.parametrize("cid", list(GENERATE))
def test_generate_gives_one_process_tokens(runs, cid):
    """``serve.generate`` on the rank's prompt rows, params (the serve
    layout: Granite's experts hold their FSDP dim whole) and state block:
    its rows' greedy tokens are one process's."""
    _, per_rank, _, one = runs
    got = (_whole(per_rank, cid, "tokens") if "/b" in cid
           else _rows(per_rank, cid, "tokens", cid.split("/")[2]))
    assert np.array_equal(got, one[cid].numpy())


# ---------------------------------------------------------------------------
# rows the data axes do not divide: whole on every data rank

@pytest.mark.parametrize("wid", WHOLE_IDS)
def test_whole_rows_decode_matches_the_reference_and_one_process(runs, wid):
    """B = 1 and B = 3 on (2, 2): every rank decodes all B rows (the
    reference's ``serve_batch_spec`` ``(None,)``), the same bits on every
    rank; the logits of every step within 1e-5 of max|logits| of the
    reference's own mesh decode and of one process, and the state's
    blocks gathered whole within 1e-5 of one process's."""
    _, per_rank, reference, one = runs
    cid = f"decode/{wid}"
    got = _whole(per_rank, cid, "logits")
    want_ref = reference[cid]
    want_one = one[cid][0].numpy()
    assert np.isfinite(got).all() and got.shape == want_ref.shape
    for want in (want_ref, want_one):
        errs = [_rel_err(got[:, t], want[:, t]) for t in range(STEPS)]
        assert max(errs) <= 1e-5, errs
    state = tree_leaves(per_rank[0][cid]["state"])
    for g, w in zip(state, tree_leaves(one[cid][1])):
        assert _rel_err(g.numpy(), w.numpy()) <= 1e-5


@pytest.mark.parametrize("wid", WHOLE_IDS)
def test_whole_rows_prefill_matches_the_reference_and_one_process(runs,
                                                                  wid):
    _, per_rank, reference, one = runs
    cid = f"prefill/{wid}"
    got = _whole(per_rank, cid, "h")
    assert np.isfinite(got).all()
    assert _rel_err(got, reference[cid]) <= 1e-5
    assert _rel_err(got, one[cid][0].numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# prefill below the threshold

@pytest.mark.parametrize("cid", PREFILL_IDS)
def test_short_prefill_matches_the_reference_and_one_process(runs, cid):
    _, per_rank, reference, one = runs
    got = _rows(per_rank, f"prefill/{cid}", "h", cid.split("/")[1])
    assert np.isfinite(got).all()
    assert _rel_err(got, reference[f"prefill/{cid}"]) <= 1e-5
    assert _rel_err(got, one[f"prefill/{cid}"][0].numpy()) <= 1e-5


@pytest.mark.parametrize("cid", PREFILL_IDS)
def test_short_loss_and_gradients_match_one_process(runs, cid):
    _, per_rank, _, one = runs
    _, loss, grads = one[f"prefill/{cid}"]
    losses = [res[f"prefill/{cid}"]["loss"] for res in per_rank]
    assert all(torch.equal(x, losses[0]) for x in losses)
    assert abs(float(losses[0]) - loss) <= 1e-5
    got = _flat(per_rank[0][f"prefill/{cid}"]["grads"])
    assert set(got) == set(grads)
    for k, w in grads.items():
        assert _rel_err(got[k], w) <= 1e-4, k


def test_train_step_on_a_whole_block_as_long_as_a_cut_one(runs):
    """The group train step on (1, 4) at T = 32, below the threshold of
    64 (each rank's block (B/k, 32) as long as a cut block of 128): its
    losses, aggregate norm and the params after it are one process's."""
    _, per_rank, _, one = runs
    cid = "train/h2o_band/1x4"
    want_m, want_p = one[cid]
    for res in per_rank:
        for k in ("loss_mean", "loss_median", "agg_grad_norm"):
            got, want = float(res[cid]["metrics"][k]), float(want_m[k])
            assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), k
    got = _flat(per_rank[0][cid]["params"])
    for k, w in _flat(want_p).items():
        assert _rel_err(got[k], w) <= 1e-5, k


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-1b-a400m",
                                  "seamless-m4t-medium"])
def test_a_dense_batch_that_is_no_rank_block_is_refused(arch):
    """Under a mesh a dense, MoE or audio batch is the rank's block from
    ``sharding.local_batch``, which records whether its sequence is cut:
    a plain dict (whose shape cannot say it) is refused, never run."""
    cfg = dr.cfg_of({"arch": arch})
    params = model.init(0, cfg, device="cpu")
    tok = torch.zeros((1, 16), dtype=torch.int64)
    batch = {"tokens": tok, "labels": tok}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, 16, cfg.d_model))
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        with pytest.raises(TypeError, match="local_batch"):
            model.forward(params, cfg, batch)
        with pytest.raises(TypeError, match="local_batch"):
            model.loss_fn(params, batch, cfg)
        block = sharding.local_batch(batch, mesh, cfg)
        assert isinstance(block, meshctx.Block)
        assert block.cut == set(batch)             # 16 >= 16 |model|
        assert tree_map(lambda t: t[:1], block).cut == block.cut


# ---------------------------------------------------------------------------
# layouts the decode does not take

def _mesh(shape):
    axes = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes, coords={a: 0 for a in axes})


@pytest.mark.parametrize("arch,overrides,rows,max_len,match", [
    ("h2o-danube-3-4b", {"sliding_window": 6}, 4, 16, "cache"),
    ("h2o-danube-3-4b", {}, 3, 16, "rows"),
    ("zamba2-2.7b", {"ssm_head_dim": 256}, 4, 16, "ssm")])
def test_other_decode_layouts_are_refused(arch, overrides, rows, max_len,
                                          match):
    """A cache of 6 slots on 4 model ranks (the reference's rule cuts its
    head dim) and Mamba2 heads |model| does not divide are refused by
    name, never decoded.  Rows the data axes do not divide, once refused
    too, are taken: whole on every data rank, the cache's slots over
    ``model`` (the reference's rule, finding no batch dim, would cut the
    layers)."""
    cfg = dr.cfg_of({"arch": arch, "overrides": overrides})
    mesh = _mesh((2, 2) if rows == 3 else (1, 4))
    state = model.init_decode_state(cfg, rows, max_len, device="cpu")
    if match == "rows":
        specs = sharding.decode_state_specs(state, mesh, cfg, rows)
        assert set(sharding.spec_leaves(state, specs)) == {
            (None, None, "model", None, None)}
        assert set(sharding.spec_leaves(state, sharding.decode_state_shardings(
            state, mesh, cfg, rows))) == {("model", None, None, None, None)}
        local = sharding.local_decode_state(state, mesh, cfg, rows)
        for t in tree_leaves(local):
            assert t.shape == (2, rows, max_len // 2, 2, 64)
        return
    with pytest.raises(NotImplementedError, match=match):
        sharding.local_decode_state(state, mesh, cfg, rows)


def test_whole_rows_refuse_a_cache_model_does_not_divide():
    """Whole rows on a (2, 4) mesh: a cache of 6 slots on 4 model ranks is
    refused by name."""
    cfg = dr.cfg_of({"arch": "h2o-danube-3-4b",
                     "overrides": {"sliding_window": 6}})
    state = model.init_decode_state(cfg, 3, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="cache/self/k"):
        sharding.local_decode_state(state, _mesh((2, 4)), cfg, 3)


@pytest.mark.parametrize("rows", [1, 3])
def test_train_rows_the_data_axes_do_not_divide_are_refused(rows):
    """A train batch's rows are cut over the data axes (the reference's
    ``train_batch_spec``): rows they do not divide are refused, and a
    loss on a serve block of whole rows too."""
    cfg = dr.cfg_of({"arch": "h2o-danube-3-4b"})
    mesh = _mesh((2, 2))
    tok = torch.zeros((2, rows, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError,
                       match=f"{rows} rows a group on 2 data ranks: the "
                       "reference's train_batch_spec"):
        sharding.local_train_batch({"tokens": tok, "labels": tok}, mesh,
                                   cfg)
    block = sharding.local_batch({"tokens": tok[0], "labels": tok[0]}, mesh,
                                 cfg)
    assert block.rows_whole and block["tokens"].shape == (rows, 8)
    params = model.init(0, cfg, device="cpu")
    with meshctx.set_mesh(mesh), pytest.raises(NotImplementedError,
                                               match="train_batch_spec"):
        model.loss_fn(params, block, cfg)
