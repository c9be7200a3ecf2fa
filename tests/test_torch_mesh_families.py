"""The hybrid, audio and vlm families on the port's model mesh
(``models/model.py``, ``models/mamba.py``'s channel-parallel block,
``launch/sharding.py``'s cuts, ``launch/steps.py``'s group step) against
the JAX package.

One module-scoped spawn of 4 gloo ranks (``repro_torch.launch.ranks``,
one thread each) builds a (2, 2) and a (1, 4) ("data", "model") mesh over
the same ranks; the rank bodies are tests/torch_mesh_family_ranks.py.
While the ranks run, this process runs the reference's dense ``loss_fn``
and gradient, its unsharded group step (jitted, the original threefry)
and the port's one-process loss, gradients and prefill on the same
inputs (the port's init, handed to the reference and to the ranks as
numpy, and built back by ``convert``).  The
reference's own whole-model mesh path fails on jax 0.9.0 (its layer
scan's carry comes back T-sharded), so it is not run.

Reduced configs in float32:

* Zamba2 at 4 layers (the shared block applied twice), (B, T) = (4, 64)
  on both meshes: the Mamba2 blocks channel-parallel (16 heads over 2 or
  4 model ranks), the shared block sequence-parallel on the rank's T
  block; at Mamba2 heads of 256 (2 heads) on (1, 4) the block runs whole
  on every rank (the replicated fallback); with the gated norm over the
  rank's channels alone (a planted fault) the loss must miss;
* SeamlessM4T, (4, 32) tokens and 32 frames on (2, 2): the encoder
  sequence-parallel over the frames, its output gathered into the memory;
* InternVL2, 16 patches + 48 tokens, B = 2, on (1, 4): rank 0's block
  holds only patches.

Limits: the loss within 1e-5 and every leaf's gradient within 1e-4 of
its max|g|, of one process and of the reference; prefill hidden states
within 1e-5 of max|h| of one process; the group step (k = 4, q = 1, gmom
of 4 Weiszfeld iterates under sign_flip, SGD 0.1, two steps, both
variants) under ``compare_traces`` of the reference's unsharded step on
its metrics, its params within 1e-4 of max|p|.  SGD, not AdamW: AdamW's
first update is ±lr a coordinate whatever the gradient.
"""

import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import robust_train as jrt
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.launch import ranks, sharding
from repro_torch.models import blocks, mamba, model
from repro_torch.sim.goldens import compare_traces

import torch_mesh_family_ranks as fr

WORLD = 4
ZAMBA, SEAMLESS, VLM = "zamba2-2.7b", "seamless-m4t-medium", "internvl2-26b"
# (arch, overrides, rows, tokens, patches or frames): a model's inputs
MODELS = {"zamba2": (ZAMBA, {"num_layers": 4}, 4, 64, 0),
          "zamba2_replicated": (ZAMBA, {"num_layers": 4,
                                        "ssm_head_dim": 256}, 4, 64, 0),
          "seamless": (SEAMLESS, {}, 4, 32, 32),
          "internvl2": (VLM, {}, 2, 48, 16)}
# (case id, model, mesh)
MODEL_CASES = [("zamba2/2x2", "zamba2", "2x2"),
               ("zamba2/1x4", "zamba2", "1x4"),
               ("zamba2_replicated/1x4", "zamba2_replicated", "1x4"),
               ("seamless/2x2", "seamless", "2x2"),
               ("internvl2/1x4", "internvl2", "1x4")]
PREFILL_CASES = ["zamba2/2x2", "seamless/2x2", "internvl2/1x4"]
# the group step: (model, mesh, rows a group, tokens)
K, Q, SEED, LR = 4, 1, 10, 0.1
STEP_MODELS = {"zamba2": ("2x2", 2, 32), "seamless": ("2x2", 2, 32),
               "internvl2": ("1x4", 1, 48)}
VARIANTS = ("shard_local", "gathered")
STEP_IDS = [f"step/{m}/{v}" for m in STEP_MODELS for v in VARIANTS]
RC = dict(num_workers=K, num_byzantine=Q, num_batches=K, aggregator="gmom",
          attack="sign_flip", gmom_max_iters=4)


@pytest.fixture(autouse=True)
def _one_thread_and_original_threefry():
    old = torch.get_num_threads(), jax.config.jax_threefry_partitionable
    torch.set_num_threads(1)
    jax.config.update("jax_threefry_partitionable", False)
    yield
    torch.set_num_threads(old[0])
    jax.config.update("jax_threefry_partitionable", old[1])


def _inputs(name, rows, tokens, seed):
    """A numpy batch of ``name``'s model: tokens, labels and its patches
    or frames."""
    arch, _, _, _, extra = MODELS[name]
    cfg = fr._cfg({"arch": arch, "overrides": MODELS[name][1]})
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (rows, tokens)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (rows, extra, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, extra, cfg.d_model)).astype(np.float32)
    return batch


def _models():
    """{model: (port cfg, numpy params, batch)}: the port's init, handed
    to the ranks and to the reference as numpy."""
    out = {}
    for i, (name, (arch, ov, rows, tokens, _)) in enumerate(MODELS.items()):
        cfg = fr._cfg({"arch": arch, "overrides": ov})
        params = tree_map(lambda t: t.numpy(), model.init(i, cfg,
                                                          device="cpu"))
        out[name] = (cfg, params, _inputs(name, rows, tokens, seed=100 + i))
    return out


def _jcfg(name):
    arch, ov = MODELS[name][:2]
    return jconfigs.get_config(arch).reduced().with_(**ov)


def _step_batches(name, rows, tokens):
    """Two steps' (K, rows, ...) numpy batches."""
    return [tree_map(lambda a: a.reshape((K, rows) + a.shape[1:]),
                     _inputs(name, K * rows, tokens, seed=200 + t))
            for t in range(2)]


def _cases(models):
    cases = {}
    for cid, name, mesh in MODEL_CASES:
        arch, ov = MODELS[name][:2]
        cases[f"model/{cid}"] = dict(kind="model", arch=arch, overrides=ov,
                                     params=models[name][1],
                                     batch=models[name][2], mesh=mesh)
    cases["model/zamba2/2x2/rank_norm"] = dict(cases["model/zamba2/2x2"],
                                               fault=True)
    for cid in PREFILL_CASES:
        cases[f"prefill/{cid}"] = dict(cases[f"model/{cid}"], kind="prefill")
    cases["mamba/1x4"] = dict(kind="mamba", mesh="1x4",
                              **fr.mamba_inputs(fr.MAMBA_SPEC))
    for name, (mesh, rows, tokens) in STEP_MODELS.items():
        arch, ov = MODELS[name][:2]
        for v in VARIANTS:
            cases[f"step/{name}/{v}"] = dict(
                kind="step", arch=arch, overrides=ov, params=models[name][1],
                batches=_step_batches(name, rows, tokens), mesh=mesh,
                variant=v, rc=RC, lr=LR, seed=SEED, min_fsdp_elems=1 << 12)
    return cases


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v.detach() if torch.is_tensor(v) else v,
                                   np.float32)
    return out


def _parent_work(models, cases):
    """This process's results: {model: (the reference's loss and flat
    gradients, the port's one-process loss, flat gradients and hidden
    states)} and {model: the reference's step rows and flat params}."""
    dense = {}
    for name, (cfg, npp, batch) in models.items():
        jcfg, jp = _jcfg(name), jax.tree.map(jnp.asarray, npp)
        wl, wg = jax.jit(jax.value_and_grad(
            lambda p, b, jcfg=jcfg: jmodel.loss_fn(p, b, jcfg)))(jp, batch)
        params = tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_numpy(cfg, npp, "cpu"))
        tb = fr._batch(batch)
        loss = model.loss_fn(params, tb, cfg)
        loss.backward()
        with torch.no_grad():
            h = model.prefill(params, cfg, tb)
        dense[name] = (float(wl), _flat(jax.tree.map(np.asarray, wg)),
                       float(loss.detach()),
                       _flat(tree_map(lambda t: t.grad, params)), h.numpy())
    stepped = {}
    for name in STEP_MODELS:
        jp = jax.tree.map(jnp.asarray, models[name][1])
        jopt = joptim.sgd(LR)
        step = jax.jit(jsteps.make_group_train_step(
            _jcfg(name), jrt.RobustConfig(**RC), jopt))
        p, s, rows = jp, jopt.init(jp), []
        for t, b in enumerate(cases[f"step/{name}/shard_local"]["batches"]):
            p, s, m = step(p, s, b, jax.random.PRNGKey(SEED + t), t)
            rows.append({k: float(v) for k, v in m.items()})
        stepped[name] = (rows, _flat(jax.tree.map(np.asarray, p)))
    return dense, stepped


@pytest.fixture(scope="module")
def runs():
    """(cases, the 4 ranks' results in rank order, this process's dense
    results, the reference's steps)."""
    threads = torch.get_num_threads()
    partitionable = jax.config.jax_threefry_partitionable
    torch.set_num_threads(1)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        models = _models()
        cases = _cases(models)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            spawned = pool.submit(ranks.run, fr.run_cases, WORLD, cases,
                                  timeout=600.0)
            dense, stepped = _parent_work(models, cases)
            per_rank = spawned.result()
    finally:
        torch.set_num_threads(threads)
        jax.config.update("jax_threefry_partitionable", partitionable)
    return cases, per_rank, dense, stepped


# ---------------------------------------------------------------------------
# helpers

def _rel_err(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def _check_grads(got, want, rtol, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        assert _rel_err(got[k], w) <= rtol, (what, k, _rel_err(got[k], w))


def _mesh_loss(per_rank, cid):
    """The loss every rank returns (the same bits on every rank)."""
    losses = [res[cid]["loss"] for res in per_rank]
    assert all(torch.equal(x, losses[0]) for x in losses), cid
    return float(losses[0])


def _blocks(per_rank, cid, mesh, seq_dim):
    """The whole (B, ...) hidden states from the ranks' blocks (rank
    d |model| + m): each data row's model blocks joined along
    ``seq_dim`` (None: whole on every model rank, which must agree)."""
    (nd, nm), _ = fr.MESHES[mesh]
    rows = []
    for d in range(nd):
        parts = [per_rank[d * nm + m][cid]["h"] for m in range(nm)]
        if seq_dim is None:
            assert all(torch.equal(p, parts[0]) for p in parts), cid
            rows.append(parts[0])
        else:
            rows.append(torch.cat(parts, seq_dim))
    return torch.cat(rows, 0).numpy()


# ---------------------------------------------------------------------------
# loss and gradients

@pytest.mark.parametrize("cid,name,mesh", MODEL_CASES)
def test_loss_and_gradients_match_one_process(runs, cid, name, mesh):
    _, per_rank, dense, _ = runs
    _, _, loss, grads, _ = dense[name]
    got = _mesh_loss(per_rank, f"model/{cid}")
    assert np.isfinite(got) and abs(got - loss) <= 1e-5, (got, loss)
    _check_grads(_flat(per_rank[0][f"model/{cid}"]["grads"]), grads, 1e-4,
                 cid)


@pytest.mark.parametrize("cid,name,mesh", MODEL_CASES)
def test_loss_and_gradients_match_the_reference(runs, cid, name, mesh):
    _, per_rank, dense, _ = runs
    loss, grads = dense[name][:2]
    got = _mesh_loss(per_rank, f"model/{cid}")
    assert abs(got - loss) <= 1e-5, (got, loss)
    _check_grads(_flat(per_rank[0][f"model/{cid}"]["grads"]), grads, 1e-4,
                 cid)


def test_a_per_rank_gated_norm_fails(runs):
    """The planted fault: the Mamba2 gated norm over the rank's channels
    alone (no psum of the sum of squares) gives a finite loss that misses
    one process's by ten times the limit, and gradients by ten times
    theirs."""
    _, per_rank, dense, _ = runs
    _, _, loss, grads, _ = dense["zamba2"]
    got = _mesh_loss(per_rank, "model/zamba2/2x2/rank_norm")
    assert np.isfinite(got) and abs(got - loss) > 10 * 1e-5, (got, loss)
    mesh_grads = _flat(per_rank[0]["model/zamba2/2x2/rank_norm"]["grads"])
    assert max(_rel_err(mesh_grads[k], g) for k, g in grads.items()) > 1e-3


def test_a_patch_only_rank_gives_the_global_loss(runs):
    """InternVL2 on (1, 4): rank 0's block of the 64-position stream holds
    only the 16 patches; it returns the same finite loss as the text
    ranks (a zero token sum and count of its own) and no hidden state."""
    _, per_rank, dense, _ = runs
    losses = [float(res["model/internvl2/1x4"]["loss"]) for res in per_rank]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1
    assert abs(losses[0] - dense["internvl2"][2]) <= 1e-5
    assert [tuple(res["prefill/internvl2/1x4"]["h"].shape)
            for res in per_rank] == [(2, 0, 256)] + [(2, 16, 256)] * 3


def test_mamba_block_matches_one_process(runs):
    """One channel-parallel Mamba2 block on (1, 4): 2 heads a rank, the
    output the same bits on every rank and one process's within 1e-5 of
    max|out|, every gradient (the TP leaves' gathered, the others' and the
    stream's psum'd over model) within 1e-5 of its max."""
    cases, per_rank, _, _ = runs
    out, x_grad, grads = fr.mamba_one_process(cases["mamba/1x4"])
    got = per_rank[0]["mamba/1x4"]
    assert all(torch.equal(res["mamba/1x4"]["out"], got["out"])
               for res in per_rank)
    assert _rel_err(got["out"].numpy(), out.numpy()) <= 1e-5
    assert _rel_err(got["x_grad"].numpy(), x_grad.numpy()) <= 1e-5
    _check_grads(_flat(got["grads"]), _flat(grads), 1e-5, "mamba")


@pytest.mark.parametrize("cid", [c[0] for c in MODEL_CASES])
def test_model_cases_repeat_bit_for_bit(runs, cid):
    _, per_rank, _, _ = runs
    assert all(res[f"model/{cid}"]["repeat_equal"] for res in per_rank)


def test_mamba_leaves_are_channel_parallel():
    """The compute layout cuts the Mamba2 TP leaves (Din columns, H heads,
    Din rows, the gated norm) over model where |model| divides the heads,
    and keeps w_B, w_C, their convs and the block's own norm whole;
    where it does not, every leaf is whole."""
    for (shape, axes), ov, tp in ((fr.MESHES["2x2"], {}, True),
                                  (fr.MESHES["1x4"], {}, True),
                                  (fr.MESHES["1x4"], {"ssm_head_dim": 256},
                                   False)):
        mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=axes,
                                     coords={a: 0 for a in axes})
        cfg = fr._cfg({"arch": ZAMBA, "overrides": dict(num_layers=4, **ov)})
        spec = blocks.mamba_spec(cfg)
        assert mamba.tp_applies(mesh, spec) == tp
        full = model.init(0, cfg, device="cpu")
        local = sharding.local_params(full, mesh, cfg)
        n = mesh.shape["model"] if tp else 1
        m = local["mamba"]
        for name in ("w_z", "w_x", "conv_x", "conv_x_b"):
            assert m[name].shape[-1] == spec.d_inner // n, name
        for name in ("w_dt", "A_log", "dt_bias", "D"):
            assert m[name].shape[-1] == spec.num_heads // n, name
        assert m["w_out"].shape[-2] == spec.d_inner // n
        assert m["norm"]["scale"].shape[-1] == spec.d_inner // n
        for name in ("w_B", "w_C", "conv_B", "conv_C", "conv_B_b",
                     "conv_C_b"):
            assert m[name].shape == full["mamba"][name].shape, name
        assert m["ln"]["scale"].shape == full["mamba"]["ln"]["scale"].shape


def test_a_memory_the_data_axes_do_not_divide_is_refused():
    """The reference's condition for its sequence-parallel
    cross-attention, memory.shape[0] % data == 0: a serve batch whose
    frames the data axes do not divide keeps them whole on every data
    rank with its rows (``serve_batch_spec``'s ``(None,)``; once refused,
    now served: tests/test_torch_mesh_decode.py runs it), the stream
    below the threshold; a train batch's rows, which the reference always
    cuts, are refused."""
    shape, axes = fr.MESHES["2x2"]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes,
                                 coords={a: 0 for a in axes})
    cfg = fr._cfg({"arch": SEAMLESS})
    batch = fr._batch(_inputs("seamless", 3, 32, seed=0))
    block = sharding.local_batch(batch, mesh, cfg)
    assert block.rows_whole and not block.cut
    assert block["frames"].shape == batch["frames"].shape
    with pytest.raises(NotImplementedError, match="train_batch_spec"):
        sharding.local_train_batch(tree_map(lambda t: t[None], batch), mesh,
                                   cfg)


# ---------------------------------------------------------------------------
# prefill

@pytest.mark.parametrize("cid", PREFILL_CASES)
def test_prefill_matches_one_process(runs, cid):
    cases, per_rank, dense, _ = runs
    name, mesh = cid.split("/")
    family = fr._cfg(cases[f"prefill/{cid}"]).family
    got = _blocks(per_rank, f"prefill/{cid}", mesh,
                  None if family == "hybrid" else 1)
    want = dense[name][4]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) <= 1e-5, _rel_err(got, want)


# ---------------------------------------------------------------------------
# the group step

@pytest.mark.parametrize("cid", STEP_IDS)
def test_group_step_matches_the_reference_unsharded_step(runs, cid):
    _, per_rank, _, stepped = runs
    rows, params = stepped[cid.split("/")[1]]
    got = per_rank[0][cid]
    trace = {"history": [{k: float(v) for k, v in r.items()}
                         for r in got["metrics"]]}
    assert not compare_traces(trace, {"history": rows}), cid
    assert all(res[cid]["same_everywhere"] for res in per_rank)
    for res in per_rank[1:]:
        for a, b in zip(res[cid]["metrics"], got["metrics"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    _check_grads(_flat(got["params"]), params, 1e-4, cid)
