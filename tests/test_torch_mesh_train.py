"""The group train step on the model mesh (``launch/steps.py`` under
``meshctx.set_mesh``, ``launch/sharding.py``'s storage layout,
``core/shard_aggregation.py``'s 2D layout) against the JAX package.

One module-scoped spawn of 8 gloo ranks (``repro_torch.launch.ranks``,
one thread each) is the reference's (4, 2) ("data", "model") mesh and,
over the same ranks, a (2, 2, 2) ("pod", "data", "model") one; the rank
bodies are tests/torch_mesh_train_ranks.py.  Every case runs twice and
repeats bit for bit.  While the ranks run, this process runs the
reference's unsharded ``make_group_train_step`` (jitted, the original
threefry), the port's unsharded step and the 2D layout's ``virtual``
oracle on the same numpy inputs.

* The group step, k = 4 groups, q = 1, gmom (four Weiszfeld iterates)
  under sign_flip, two steps,
  on the reduced minitron-4b (AdamW, one microbatch), h2o-danube-3-4b
  (SGD, two microbatches, ``stealth_then_strike``), granite-moe-1b-a400m
  at capacity factor 8.0 (SGD, one microbatch; no assignment dropped,
  in EP's buffers or the dense one's) and rwkv6-7b (SGD, one
  microbatch), each shard-local and (but H2O, a second dense one)
  gathered, with FSDP storage from
  4096 elements a leaf (so the dense leaves are cut over ``data`` too),
  and minitron shard-local on the (2, 2, 2) mesh: metrics at rel 1e-5,
  params at 1e-4 of each leaf's max|p| plus a tenth of AdamW's learning
  rate (``STEP_ATOL``, as tests/test_torch_train.py holds the unsharded
  step), SGD's params at 1e-5 of max|p| plus 1e-7; against the port's
  unsharded step the same limits.  Only minitron trains with AdamW:
  under AdamW, RWKV6's port-unsharded step sits 1.65e-4 from the
  reference's on one leaf after two steps, and H2O's mesh step sits past
  ``STEP_ATOL`` from the port's unsharded one (a coordinate whose
  gradient is near eps moves by a share of lr on its last bits, and the
  mesh sums in another order), so those train with SGD, held tightly.
* Every leaf's gradient through the step's own halves
  (``sharding.compute_params``, the model's gradient under
  ``meshctx.param_sums_deferred``, ``sharding.storage_grads``) against
  the port's dense gradient (1e-5 of its max|g|): the storage layout's
  reduce-scatter sums each leaf once, the regions' own sums included.
* Shard-local aggregation on the 2D layout, no model: the 15 rules under
  sign_flip (and signSGD on the packed sign wire) and the 12 attacks
  under gmom on random (4, *param) gradients of the reduced minitron's
  shapes, and AdamW's clip norm, ``torch.equal`` on every rank to the
  ``virtual`` oracle's blocks and within 1e-5 (of max|agg|) of the
  unsharded path; the gathered variant through the round kernel's plain
  version the same bits on every rank and equal to it unsharded.
* ``storage_params`` then ``gather_params`` is the identity for every
  architecture's reduced config.
* The int8 wire on the 2D layout: the ``int8_stochastic`` encode of the
  reduced minitron's (4, *param) tree (leaves cut over ``data``, over
  ``model`` and over both, a (4,) leaf, a bf16 leaf, an all-zero row) on
  the (4, 2) and (2, 2, 2) meshes: every rank's ``q`` block
  ``torch.equal`` to the cut of the reference's unsharded
  ``_int8_encode`` (jitted, the original threefry) and every scale its
  bits; the virtual oracle the same whole; keys folded by the block's
  coordinates, and scales from the block's own maxima, must miss.  The
  mesh step with ``int8_gmom`` on the wire, shard-local and gathered,
  SGD, one step: metrics at rel 1e-5 of the reference's and the port's
  unsharded int8 steps; params within the SGD limit plus lr x each
  leaf's largest scale, with at most ``FLIP_SHARE`` of a leaf's
  coordinates past the limit (a rounding that flips by one step where
  the mesh sums a gradient in another order), which a wrong key
  exceeds; the first payload within one rounding step of the port's
  unsharded one; and every step's payload, on every rank, the cut of
  the unsharded encode of its own stack gathered whole.

The pieces in one process (no ranks): the block shapes on (16, 16) and
(2, 16, 16) against the reference's ``param_partition_spec``, the new
spec functions against the reference's, the step's refusals, and remat's
recompute under the forward's mesh from another thread (the card's
autograd device thread).
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro import optim as joptim
from repro.configs import ARCHITECTURES
from repro.configs import get_config as jget_config
from repro.core import byzantine as jbyz
from repro.core import robust_train as jrt
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import aggregators, byzantine
from repro_torch.core import robust_train as trt
from repro_torch.core import shard_aggregation as sa
from repro_torch.launch import ranks, sharding, steps
from repro_torch.models import meshctx, model

import torch_mesh_ranks
import torch_mesh_train_ranks

WORLD = 8
K, Q, T = 4, 1, 32
SEED = 10
FSDP_ELEMS = 1 << 12
ADAM_LR, SGD_LR = 1e-3, 0.1
STEP_ATOL = 0.1 * ADAM_LR
OVERRIDES = {"granite-moe-1b-a400m": {"moe_capacity_factor": 8.0}}
# (optimizer, microbatches, schedule) of each architecture's step
SETTINGS = {"minitron-4b": ("adamw", 1, None),
            "h2o-danube-3-4b": ("sgd", 2, "stealth_then_strike"),
            "granite-moe-1b-a400m": ("sgd", 1, None),
            "rwkv6-7b": ("sgd", 1, None)}
# four Weiszfeld iterates a round keep the CPU ranks' rounds short
RC = dict(num_workers=K, num_byzantine=Q, num_batches=K, aggregator="gmom",
          attack="sign_flip", gmom_max_iters=4)
RULES = sorted(aggregators.available())
ATTACKS = sorted(byzantine.available())
# the gathered variant differs from the shard-local one only after the
# stacked gradients, so one dense architecture (minitron) takes it
VARIANTS = {a: ("shard_local",) if a == "h2o-danube-3-4b"
            else ("shard_local", "gathered") for a in SETTINGS}
STEP_IDS = [f"step/{a}/{v}" for a in SETTINGS
            for v in VARIANTS[a]] + ["step/pod/minitron-4b"]
# the int8 wire: int8_gmom on int8_stochastic, minitron under SGD
INT8_ARCH = "minitron-4b"
INT8_RC = dict(RC, aggregator="int8_gmom", compression="int8_stochastic")
INT8_STEP_IDS = [f"int8step/{INT8_ARCH}/{v}"
                 for v in ("shard_local", "gathered")]
INT8_FAULT_ID = f"int8step/{INT8_ARCH}/wrong_key"
# at most this share of a leaf's coordinates may sit past the SGD limit
# (by at most lr x the leaf's largest scale: a stochastic rounding that
# flips by one step where the mesh sums a gradient in another order)
FLIP_SHARE = 1e-3
INT8_MESHES = ("4x2", "2x2x2")
INT8_FAULTS = ("block_keys", "block_amax")


@pytest.fixture(autouse=True)
def _one_thread_and_original_threefry():
    old = torch.get_num_threads(), jax.config.jax_threefry_partitionable
    torch.set_num_threads(1)
    jax.config.update("jax_threefry_partitionable", False)
    yield
    torch.set_num_threads(old[0])
    jax.config.update("jax_threefry_partitionable", old[1])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(arch):
    return dataclasses.replace(jget_config(arch).reduced(),
                               **OVERRIDES.get(arch, {}))


def _cfg(arch):
    return configs.get_config(arch).reduced().with_(**OVERRIDES.get(arch, {}))


def _step_inputs():
    """{arch: (numpy params, [tokens (K, B/K, T)] x 2)}: the port's init
    (handed to the reference as numpy) and random tokens, B/K = 4 rows a
    microbatch."""
    rng = np.random.default_rng(0)
    out = {}
    for arch, (_, mb, _) in SETTINGS.items():
        cfg = _cfg(arch)
        params = tree_map(lambda t: t.numpy(),
                          model.init(7, cfg, device="cpu"))
        toks = [rng.integers(0, cfg.vocab_size, (K, 4 * mb, T))
                for _ in range(2)]
        out[arch] = (params, toks)
    return out


def _agg_grads():
    """Random (K, *param) f32 gradients of the reduced minitron's shapes,
    in its params' insertion order."""
    cfg = _cfg("minitron-4b")
    rng = np.random.default_rng(1)
    shapes = model.init(0, cfg, device="cpu")
    return tree_map(lambda t: rng.standard_normal(
        (K,) + tuple(t.shape)).astype(np.float32), shapes)


def _cases(inputs, grads):
    cases = {}
    for arch, (opt, mb, sched) in SETTINGS.items():
        params, toks = inputs[arch]
        base = dict(kind="step", arch=arch, overrides=OVERRIDES.get(arch, {}),
                    params=params, batches=toks, seed=SEED, opt=opt,
                    lr=ADAM_LR if opt == "adamw" else SGD_LR,
                    microbatches=mb, schedule=sched, rc=RC,
                    min_fsdp_elems=FSDP_ELEMS, target_backend="cpu")
        for v in VARIANTS[arch]:
            cases[f"step/{arch}/{v}"] = dict(base, variant=v)
        cases[f"grad/{arch}"] = dict(
            kind="grad", arch=arch, overrides=OVERRIDES.get(arch, {}),
            params=params, tokens=toks[0][0], min_fsdp_elems=FSDP_ELEMS)
    cases["step/pod/minitron-4b"] = dict(cases["step/minitron-4b/shard_local"],
                                         mesh="2x2x2")
    int8 = dict(cases[f"step/{INT8_ARCH}/shard_local"], opt="sgd",
                lr=SGD_LR, rc=INT8_RC, batches=inputs[INT8_ARCH][1][:1])
    # the gathered variant runs once: its aggregation is the unsharded
    # path's, whose repeat the other gathered cases hold
    for cid in INT8_STEP_IDS:
        variant = cid.split("/")[2]
        cases[cid] = dict(int8, variant=variant,
                          repeat=variant == "shard_local")
    cases[INT8_FAULT_ID] = dict(int8, fault="wrong_key", repeat=False)
    for mesh in INT8_MESHES:
        cases[f"int8/{mesh}"] = _int8_case(grads, mesh)
    for fault in INT8_FAULTS:
        cases[f"int8/fault/{fault}"] = dict(_int8_case(grads, "4x2"),
                                            fault=fault, repeat=False)
    agg = dict(kind="aggregate", arch="minitron-4b", grads=grads,
               seed=SEED, min_fsdp_elems=FSDP_ELEMS)
    for rule in RULES:
        cases[f"rule/{rule}"] = dict(agg, rc=dict(RC, aggregator=rule))
    for attack in ATTACKS:
        cases[f"attack/{attack}"] = dict(agg, rc=dict(RC, attack=attack))
    cases["rule/sign_sgd_majority/sign"] = dict(
        agg, rc=dict(RC, aggregator="sign_sgd_majority", compression="sign"))
    cases["gathered/gmom"] = dict(agg, rc=RC, gathered=True)
    cases["clip"] = dict(agg, kind="clip", clip=0.5)
    cases["roundtrip"] = dict(kind="roundtrip", archs=list(ARCHITECTURES),
                              min_fsdp_elems=FSDP_ELEMS)
    return cases


def _int8_case(grads, mesh):
    """The int8 encode's case: the reduced minitron's (K, *param) tree
    (leaves cut over ``data`` and over both axes; its ``w_down`` in
    bf16; an all-zero row of ``unembed``) and two more leaves, one cut
    over ``model`` alone and a (K,) one."""
    rng = np.random.default_rng(2)
    grads = tree_map(np.copy, grads)
    grads["unembed"][2] = 0.0
    extra = {"x_model": (rng.standard_normal((K, 8, 6)).astype(np.float32),
                         ("model", None)),
             "x_scalar": (rng.standard_normal(K).astype(np.float32), ())}
    return dict(kind="int8", arch=INT8_ARCH, grads=grads, extra=extra,
                bf16=[("layers", "mlp", "w_down")], seed=SEED + 5,
                min_fsdp_elems=FSDP_ELEMS, mesh=mesh)


# ---------------------------------------------------------------------------
# this process: the reference's unsharded step, the port's, the oracle

def _batch(tok):
    return {"tokens": tok, "labels": np.roll(tok, -1, -1)}


def _reference_step(arch, params, toks, settings=None, rc=RC):
    """The reference's unsharded group step: (metrics rows, params)."""
    opt_name, mb, sched = settings or SETTINGS[arch]
    jopt = (joptim.adamw(ADAM_LR) if opt_name == "adamw"
            else joptim.sgd(SGD_LR))
    jrc = jrt.RobustConfig(**rc)
    jsched = (jbyz.make_schedule(sched, num_workers=K, num_byzantine=Q,
                                 attack=RC["attack"]) if sched else None)
    step = jax.jit(jsteps.make_group_train_step(
        _jcfg(arch), jrc, jopt, microbatches=mb, schedule=jsched))
    p = _port_order_to_ref(params)
    s = jopt.init(p)
    astate = jsched.init_state() if jsched else None
    rows = []
    for t, tok in enumerate(toks):
        b, key = _batch(tok), jax.random.PRNGKey(SEED + t)
        if jsched:
            p, s, m, astate = step(p, s, b, key, t, astate)
        else:
            p, s, m = step(p, s, b, key, t)
        rows.append({k: float(v) for k, v in m.items()})
    return rows, _np(p)


def _port_order_to_ref(params):
    """The port's numpy params as the reference's tree (dicts sorted, as
    JAX keeps them)."""
    return jax.tree.map(jnp.asarray, params)


def _port_step(arch, params, toks, settings=None, rc=RC):
    """The port's unsharded group step: (metrics rows, params)."""
    opt_name, mb, sched = settings or SETTINGS[arch]
    cfg = _cfg(arch)
    opt = optim.adamw(ADAM_LR) if opt_name == "adamw" else optim.sgd(SGD_LR)
    tsched = (byzantine.make_schedule(sched, num_workers=K, num_byzantine=Q,
                                      attack=RC["attack"]) if sched else None)
    step = steps.make_group_train_step(cfg, trt.RobustConfig(**rc), opt,
                                       microbatches=mb, schedule=tsched)
    p = convert.lm_params_from_numpy(cfg, params, "cpu")
    s = opt.init(p)
    astate = tsched.init_state(torch.device("cpu")) if tsched else None
    rows = []
    for t, tok in enumerate(toks):
        b = tree_map(lambda a: torch.as_tensor(a).long(), _batch(tok))
        key = prng.PRNGKey(SEED + t)
        if tsched:
            p, s, m, astate = step(p, s, b, key, t, astate)
        else:
            p, s, m = step(p, s, b, key, t)
        rows.append({k: float(v) for k, v in m.items()})
    return rows, p


def _ns_mesh(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _oracle(case):
    """The virtual oracle's whole aggregate and the unsharded one."""
    mesh = _ns_mesh(*torch_mesh_train_ranks.MESHES["4x2"])
    stacked, grads = torch_mesh_train_ranks.layout_of(case, mesh)
    spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                          tuple(mesh.shape.items()), mode="virtual")
    virtual = torch_mesh_train_ranks.aggregate_case(case, grads, spec)
    plain = torch_mesh_train_ranks.aggregate_case(case, grads, None)
    return stacked, virtual, plain


def _jax_tree(tree):
    """A port tree as the reference's: bf16 leaves as bf16."""
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
        t.numpy()), tree)


def _int8_reference(cases):
    """The reference's unsharded ``_int8_encode`` (jitted) of the int8
    case's tree, and the port's virtual oracle of the (4, 2) layout."""
    from repro.core import compression as jcompression
    case = cases["int8/4x2"]
    mesh = _ns_mesh(*torch_mesh_train_ranks.MESHES["4x2"])
    _, grads = torch_mesh_train_ranks.layout_of(case, mesh)
    jcodec = jcompression.get_codec("int8_stochastic")
    ref = jax.jit(lambda t, k: jcodec.encode(t, key=k))(
        _jax_tree(grads), jax.random.PRNGKey(case["seed"]))
    ref = {k: _port_order(_np(v), grads) for k, v in ref.items()}
    out = {}
    for name in INT8_MESHES:
        mesh = _ns_mesh(*torch_mesh_train_ranks.MESHES[name])
        stacked, grads = torch_mesh_train_ranks.layout_of(case, mesh)
        spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                              tuple(mesh.shape.items()), mode="virtual")
        out[name] = (stacked, torch_mesh_train_ranks.int8_encode(
            case, grads, spec))
    return ref, out


def _parent_work(cases, inputs):
    out = {}
    params, toks = inputs[INT8_ARCH][0], inputs[INT8_ARCH][1][:1]
    int8_settings = ("sgd", 1, None)
    out["ref/int8"] = _reference_step(INT8_ARCH, params, toks,
                                      int8_settings, INT8_RC)
    with torch_mesh_train_ranks._Wire(None, None) as wire:
        out["port/int8"] = _port_step(INT8_ARCH, params, toks,
                                      int8_settings, INT8_RC)
    out["port/int8/q0"] = wire.records[0]["q"]
    out["int8"] = _int8_reference(cases)
    for arch, (params, toks) in inputs.items():
        out[f"ref/{arch}"] = _reference_step(arch, params, toks)
        out[f"port/{arch}"] = _port_step(arch, params, toks)
        cfg = _cfg(arch)
        p = tree_map(lambda t: t.requires_grad_(),
                     convert.lm_params_from_numpy(cfg, params, "cpu"))
        tok = torch.as_tensor(cases[f"grad/{arch}"]["tokens"]).long()
        loss = model.loss_fn(p, {"tokens": tok,
                                 "labels": torch.roll(tok, -1, -1)}, cfg)
        loss.backward()
        out[f"dense/{arch}"] = (float(loss.detach()),
                                tree_map(lambda t: t.grad, p))
    for cid, case in cases.items():
        if case["kind"] == "aggregate" and not case.get("gathered"):
            out[cid] = _oracle(case)
    ns = _ns_mesh(*torch_mesh_train_ranks.MESHES["4x2"])
    case = cases["clip"]
    stacked, grads = torch_mesh_train_ranks.layout_of(case, ns)
    spec = sa.layout_spec(sharding.spec_leaves(grads, stacked),
                          tuple(ns.shape.items()), mode="virtual")
    g, p = (tree_map(lambda x, i=i: x[i], grads) for i in (0, 1))
    out["clip"] = (stacked, torch_mesh_train_ranks.clip_case(case, g, p, spec),
                   torch_mesh_train_ranks.clip_case(case, g, p, None))
    case = cases["gathered/gmom"]
    _, grads = torch_mesh_train_ranks.layout_of(case, ns)
    twin = dict(case, rc=dict(case["rc"], round_backend="fused_interpret"))
    out["gathered/gmom"] = torch_mesh_train_ranks.aggregate_case(twin, grads,
                                                                 None)
    return out


@pytest.fixture(scope="module")
def runs():
    """(cases, the 8 ranks' results in rank order, this process's
    results): the reference's steps, the port's unsharded ones and the
    oracles run here while the ranks do."""
    threads = torch.get_num_threads()
    partitionable = jax.config.jax_threefry_partitionable
    torch.set_num_threads(1)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        inputs = _step_inputs()
        cases = _cases(inputs, _agg_grads())
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            spawned = pool.submit(ranks.run,
                                  torch_mesh_train_ranks.run_cases, WORLD,
                                  cases, timeout=900.0)
            here = _parent_work(cases, inputs)
            per_rank = spawned.result()
    finally:
        torch.set_num_threads(threads)
        jax.config.update("jax_threefry_partitionable", partitionable)
    return cases, per_rank, here


# ---------------------------------------------------------------------------
# helpers

def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        g = np.asarray(g.detach().float() if torch.is_tensor(g) else g,
                       np.float32)
        w = np.asarray(w.detach().float() if torch.is_tensor(w) else w,
                       np.float32)
        assert g.shape == w.shape, (what, i)
        err = float(np.abs(g - w).max())
        assert err <= rtol * float(np.abs(w).max()) + atol, (what, i, err)


def _port_order(tree, like):
    """``tree`` (the reference's, keys sorted) in ``like``'s insertion
    order, so that leaves pair up."""
    if isinstance(like, dict):
        return {k: _port_order(tree[k], v) for k, v in like.items()}
    return tree


def _param_limits(arch):
    return (1e-4, STEP_ATOL) if SETTINGS[arch][0] == "adamw" \
        else (1e-5, 1e-7)


def _arch_of(cid):
    return cid.split("/")[2] if cid.startswith("step/pod") \
        else cid.split("/")[1]


# ---------------------------------------------------------------------------
# the group step on the mesh

@pytest.mark.parametrize("cid", STEP_IDS)
def test_mesh_step_matches_the_reference_unsharded_step(runs, cid):
    _, per_rank, here = runs
    arch = _arch_of(cid)
    rows, jp = here[f"ref/{arch}"]
    got = per_rank[0][cid]
    for t, want in enumerate(rows):
        for name, w in want.items():
            assert float(got["metrics"][t][name]) == pytest.approx(
                w, rel=1e-5), (t, name)
    _close(got["params"], _port_order(jp, got["params"]),
           *_param_limits(arch), cid)


@pytest.mark.parametrize("cid", STEP_IDS)
def test_mesh_step_matches_the_port_unsharded_step(runs, cid):
    _, per_rank, here = runs
    arch = _arch_of(cid)
    rows, tp = here[f"port/{arch}"]
    got = per_rank[0][cid]
    for t, want in enumerate(rows):
        for name, w in want.items():
            assert float(got["metrics"][t][name]) == pytest.approx(
                w, rel=1e-5), (t, name)
    _close(got["params"], tp, *_param_limits(arch), cid)


@pytest.mark.parametrize("cid", STEP_IDS)
def test_mesh_step_keeps_storage_blocks(runs, cid):
    """Params and optimizer state stay the rank's storage blocks; every
    rank gathers the same whole params, and the metrics are the same bits
    on every rank."""
    cases, per_rank, _ = runs
    case = cases[cid]
    arch = case["arch"]
    shape, axes = torch_mesh_train_ranks.MESHES[case.get("mesh", "4x2")]
    ns = _ns_mesh(shape, axes)
    specs = torch_mesh_train_ranks.param_specs(
        per_rank[0][cid]["params"], ns, _cfg(arch), FSDP_ELEMS)
    for r, res in enumerate(per_rank):
        coords = per_rank[r]["coords"][case.get("mesh", "4x2")]
        want = sharding.map_specs(
            lambda _, t, s: meshctx.cut(t, s, coords, ns.shape),
            per_rank[0][cid]["params"], specs)
        for a, b in zip(tree_leaves(res[cid]["blocks"]), tree_leaves(want)):
            assert torch.equal(a, b), (cid, r)
        assert res[cid]["same_everywhere"]
        for t, row in enumerate(res[cid]["metrics"]):
            for name, v in row.items():
                assert torch.equal(v, per_rank[0][cid]["metrics"][t][name])
    mu = per_rank[0][cid]["opt_state"]
    assert int(mu.step) == 2
    if SETTINGS[arch][0] == "adamw":
        assert any(float(t.abs().max()) > 0 for t in tree_leaves(mu.mu))


@pytest.mark.parametrize("arch", list(SETTINGS))
def test_storage_gradients_match_the_dense_gradient(runs, arch):
    """Each leaf's gradient through the step's gather and reduce-scatter
    is summed once: against the dense gradient of the whole batch."""
    _, per_rank, here = runs
    loss, grads = here[f"dense/{arch}"]
    got = per_rank[0][f"grad/{arch}"]
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), (arch, err)


# ---------------------------------------------------------------------------
# shard-local aggregation on the 2D layout

AGG_IDS = [f"rule/{r}" for r in RULES] + [f"attack/{a}" for a in ATTACKS]


@pytest.mark.parametrize("cid", AGG_IDS + ["rule/sign_sgd_majority/sign",
                                           "clip"])
def test_layout_aggregation_is_its_virtual_oracle(runs, cid):
    """Each rank's blocks equal the virtual oracle's cut (the packed sign
    wire's vote, and AdamW's clip norm, a blocked sum, among them)."""
    _, per_rank, here = runs
    stacked, virtual, plain = here[cid]
    key = "update" if cid == "clip" else "agg"
    specs = sharding.map_specs(lambda _, __, s: tuple(s[1:]), stacked,
                               stacked)
    sizes = dict(zip(*reversed(torch_mesh_train_ranks.MESHES["4x2"])))
    for r, res in enumerate(per_rank):
        coords = res["coords"]["4x2"]
        want = sharding.map_specs(
            lambda _, t, s: meshctx.cut(t, s, coords, sizes), virtual, specs)
        for a, b in zip(tree_leaves(res[cid][key]), tree_leaves(want)):
            assert torch.equal(a, b), (cid, r)
    top = max(float(t.abs().max()) for t in tree_leaves(plain))
    for a, b in zip(tree_leaves(virtual), tree_leaves(plain)):
        assert float((a - b).abs().max()) <= 1e-5 * top, cid


# ---------------------------------------------------------------------------
# the int8 wire on the 2D layout

def _bits(t):
    t = torch.as_tensor(np.array(t)) if not torch.is_tensor(t) else t
    return t.contiguous().view(torch.int32)


def _int8_misses(payload, ref, stacked, coords, sizes):
    """The leaves whose ``q`` block is not the cut of the reference's (at
    ``coords``; None: the whole), or whose scales are not the reference's
    bits."""
    bad = []
    for i, (q, s, rq, rs, spec) in enumerate(zip(
            tree_leaves(payload["q"]), tree_leaves(payload["scale"]),
            tree_leaves(ref["q"]), tree_leaves(ref["scale"]),
            sharding.spec_leaves(ref["q"], stacked))):
        want = torch.as_tensor(np.array(rq))
        if coords is not None:
            want = meshctx.cut(want, spec, coords, sizes)
        if not (torch.equal(q, want) and torch.equal(_bits(s), _bits(rs))):
            bad.append(i)
    return bad


@pytest.mark.parametrize("mesh", INT8_MESHES)
def test_int8_layout_blocks_are_the_reference_payload_cut(runs, mesh):
    """Every rank's ``q`` block is its cut of the reference's unsharded
    ``_int8_encode`` payload (jitted, the original threefry), and every
    scale is the reference's, bit for bit: leaves cut over ``data``,
    ``model`` and both, a (K,) leaf, a bf16 leaf and an all-zero row; the
    virtual oracle gives the same bits whole."""
    _, per_rank, here = runs
    ref, virtual = here["int8"]
    stacked, oracle = virtual[mesh]
    assert _int8_misses(oracle, ref, stacked, None, None) == []
    sizes = dict(zip(*reversed(torch_mesh_train_ranks.MESHES[mesh])))
    for r, res in enumerate(per_rank):
        got = res[f"int8/{mesh}"]
        assert _int8_misses(got, ref, stacked, res["coords"][mesh],
                            sizes) == [], r


@pytest.mark.parametrize("fault", INT8_FAULTS)
def test_int8_planted_faults_miss_the_reference(runs, fault):
    """Keys folded by the block's coordinates, and scales from the
    block's own maxima, give some rank a payload that is not its cut."""
    _, per_rank, here = runs
    ref, virtual = here["int8"]
    stacked = virtual["4x2"][0]
    sizes = dict(zip(*reversed(torch_mesh_train_ranks.MESHES["4x2"])))
    assert any(_int8_misses(res[f"int8/fault/{fault}"], ref, stacked,
                            res["coords"]["4x2"], sizes)
               for res in per_rank)


def _int8_param_check(got, want, scales):
    """(whether every leaf sits within the SGD limit plus lr x its largest
    scale, with at most ``FLIP_SHARE`` of its coordinates past the
    limit; the largest such share)."""
    ok, worst = True, 0.0
    for g, w, sc in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(scales)):
        g = np.asarray(g.detach().float(), np.float32)
        w = np.asarray(w.detach().float() if torch.is_tensor(w) else w,
                       np.float32)
        err = np.abs(g - w)
        limit = 1e-5 * float(np.abs(w).max()) + 1e-7
        share = float((err > limit).mean())
        worst = max(worst, share)
        ok &= bool(err.max() <= limit + SGD_LR * float(sc)) \
            and share <= FLIP_SHARE
    return ok, worst


@pytest.mark.parametrize("cid", INT8_STEP_IDS)
def test_int8_mesh_step_matches_the_unsharded_steps(runs, cid):
    """``int8_gmom`` on ``int8_stochastic``, shard-local and gathered:
    metrics at rel 1e-5 of the reference's and the port's unsharded int8
    steps, params within ``_int8_param_check``'s bound of both; the
    step's own payload is, every step on every rank, the cut of the
    unsharded encode of its own stack gathered whole."""
    _, per_rank, here = runs
    got = per_rank[0][cid]
    for name in ("ref/int8", "port/int8"):
        rows, want = here[name]
        for t, row in enumerate(rows):
            for k, w in row.items():
                assert float(got["metrics"][t][k]) == pytest.approx(
                    w, rel=1e-5), (name, t, k)
        ok, share = _int8_param_check(got["params"],
                                      _port_order(want, got["params"]),
                                      got["scale"])
        print(f"{cid} vs {name}: largest share of params past the limit "
              f"{share}")
        assert ok, (name, share)
    for res in per_rank:
        assert res[cid]["wire_equal"] == [True]


@pytest.mark.parametrize("cid", INT8_STEP_IDS)
def test_int8_mesh_step_flips_single_steps(runs, cid):
    """The first step's payload on the mesh against the port's unsharded
    one: every coordinate within one rounding step, few of them off."""
    _, per_rank, here = runs
    share = []
    for a, b in zip(tree_leaves(per_rank[0][cid]["q0"]),
                    tree_leaves(here["port/int8/q0"])):
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        assert int(d.max()) <= 1
        share.append(float((d > 0).to(torch.float64).mean()))
    print(f"{cid}: share of q flipped, leaf by leaf: {share}")
    assert max(share) <= FLIP_SHARE, share


def test_int8_wrong_key_exceeds_the_bound(runs):
    _, per_rank, here = runs
    got = per_rank[0][INT8_FAULT_ID]
    _, want = here["ref/int8"]
    ok, share = _int8_param_check(got["params"],
                                  _port_order(want, got["params"]),
                                  got["scale"])
    print(f"{INT8_FAULT_ID}: largest share of params past the limit {share}")
    assert not ok, share


def test_gathered_aggregation_is_the_same_on_every_rank(runs):
    _, per_rank, here = runs
    assert all(res["gathered/gmom"]["same_everywhere"] for res in per_rank)
    for a, b in zip(tree_leaves(per_rank[0]["gathered/gmom"]["agg"]),
                    tree_leaves(here["gathered/gmom"])):
        assert torch.equal(a, b)


def test_every_case_repeats_bit_for_bit(runs):
    cases, per_rank, _ = runs
    for cid, case in cases.items():
        if case["kind"] != "roundtrip" and case.get("repeat", True):
            assert all(res[cid]["repeat_equal"] for res in per_rank), cid


def test_storage_then_gather_is_the_identity(runs):
    _, per_rank, _ = runs
    for res in per_rank:
        for name, ok in res["roundtrip"].items():
            assert bool(ok), name
    assert len(per_rank[0]["roundtrip"]) == len(ARCHITECTURES)


# ---------------------------------------------------------------------------
# in this process

@pytest.fixture(scope="module")
def full_shapes():
    """{arch: (reference config, port config, the reference's param
    shapes at full width)}."""
    return {a: (jget_config(a), configs.get_config(a), jax.eval_shape(
        lambda a=a: jmodel.init(jax.random.PRNGKey(0), jget_config(a))))
        for a in ARCHITECTURES}


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), path, leaf) for path, leaf in flat]


def _lookup(tree, names):
    for n in names:
        tree = tree[int(n) if isinstance(tree, (tuple, list)) else n]
    return tree


PROD_MESHES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh_name", list(PROD_MESHES))
def test_block_shapes_match_the_reference(full_shapes, mesh_name):
    mesh = _ns_mesh(*PROD_MESHES[mesh_name])
    for arch, (jcfg, cfg, shapes) in full_shapes.items():
        specs = sharding.param_shardings(shapes, mesh, cfg)
        for names, path, leaf in _paths(shapes):
            ref = tuple(jsharding.param_partition_spec(path, leaf, mesh,
                                                       jcfg))
            want = list(leaf.shape)
            for d, entry in enumerate(ref):
                for a in ((entry,) if isinstance(entry, str)
                          else entry or ()):
                    want[d] //= mesh.shape[a]
            assert sharding.block_shape(leaf.shape, _lookup(specs, names),
                                        mesh) == tuple(want), (arch, names)


def _ref_specs(fn, *args, **kw):
    """A reference sharding function's specs as tuples (the namespace mesh
    has no devices: its NamedSharding replaced by one that keeps the
    spec)."""
    real = jsharding.NamedSharding
    jsharding.NamedSharding = lambda _mesh, spec: types.SimpleNamespace(
        spec=tuple(spec))
    try:
        return fn(*args, **kw)
    finally:
        jsharding.NamedSharding = real


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "4x2"])
def test_new_specs_match_the_reference(mesh_name):
    shape, axes = dict(PROD_MESHES, **{"4x2": ((4, 2), ("data", "model"))})[
        mesh_name]
    mesh = _ns_mesh(shape, axes)
    for arch in ARCHITECTURES:
        jcfg, cfg = jget_config(arch).reduced(), configs.get_config(
            arch).reduced()
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                    jcfg))
        pspecs = sharding.param_shardings(shapes, mesh, cfg)
        jopt = jax.eval_shape(joptim.adamw(1e-3).init, shapes)
        want = _ref_specs(jsharding.opt_state_shardings, jopt, shapes, mesh,
                          jcfg)
        got = sharding.opt_state_shardings(
            optim.AdamState(step=jopt.step, mu=shapes, nu=shapes), shapes,
            mesh, cfg)
        assert got.step == () and want.step.spec == ()
        by_shape = {}
        for names, _, leaf in _paths(shapes):
            by_shape.setdefault(tuple(leaf.shape), _lookup(pspecs, names))
        for field in ("mu", "nu"):
            for names, _, leaf in _paths(shapes):
                mine = _lookup(getattr(got, field), names)
                ref = _pad(_lookup(getattr(want, field), names).spec,
                           leaf.ndim)
                assert mine == _lookup(pspecs, names)
                # the reference looks the spec up by shape: the first
                # param of that shape decides (RWKV6's time_mix/wo)
                assert ref == by_shape[tuple(leaf.shape)], (arch, names)
        gathered = sharding.gathered_grad_shardings(shapes, mesh)
        jg = _ref_specs(jsharding.gathered_grad_shardings, shapes, mesh)
        for names, _, _ in _paths(shapes):
            assert _lookup(gathered, names) == _lookup(jg, names).spec == ()
    batch = {"tokens": jax.ShapeDtypeStruct((4, 8, 32), jnp.int32),
             "patches": jax.ShapeDtypeStruct((4, 8, 5, 16), jnp.float32)}
    jb = _ref_specs(jsharding.batch_shardings, batch, mesh)
    got = sharding.batch_shardings(batch, mesh)
    for k, v in batch.items():
        assert got[k] == _pad(jb[k].spec, len(v.shape))
    assert sharding.replicated(mesh) == _ref_specs(jsharding.replicated,
                                                   mesh).spec


def test_the_reference_opt_state_lookup_differs_only_by_shape():
    """Where the reference's by-shape lookup gives a moment another
    param's spec: RWKV6's time_mix/wo on the production mesh."""
    mesh = _ns_mesh(*PROD_MESHES["16x16"])
    jcfg, cfg = jget_config("rwkv6-7b"), configs.get_config("rwkv6-7b")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))
    jopt = jax.eval_shape(joptim.adamw(1e-3).init, shapes)
    want = _ref_specs(jsharding.opt_state_shardings, jopt, shapes, mesh,
                      jcfg)
    pspecs = sharding.param_shardings(shapes, mesh, cfg)
    names = ("layers", "time_mix", "wo")
    leaf = _lookup(shapes, names)
    assert _pad(_lookup(want.mu, names).spec, leaf.ndim) != \
        _lookup(pspecs, names)
    got = sharding.opt_state_shardings(
        optim.AdamState(step=jopt.step, mu=shapes, nu=shapes), shapes, mesh,
        cfg)
    assert _lookup(got.mu, names) == _lookup(pspecs, names)


def test_step_refusals_on_a_mesh():
    cfg = configs.get_config("minitron-4b").reduced()
    params = model.init(0, cfg, device="cpu")
    rc = trt.RobustConfig(num_workers=2)
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        gs = sharding.stacked_grad_shardings(params, mesh, cfg)
        spec = sharding.grad_shard_spec(mesh, cfg)
        # the int8 wire on the mesh step, once refused, builds (the
        # ranks run it: test_int8_mesh_step_matches_the_unsharded_steps)
        assert callable(steps.make_group_train_step(
            cfg, dataclasses.replace(rc, compression="int8_stochastic"),
            optim.sgd(0.1), grad_shardings=gs, shard_spec=spec))
        with pytest.raises(ValueError, match="gspmd"):
            steps.make_group_train_step(
                cfg, rc, optim.sgd(0.1), grad_shardings=gs,
                shard_spec=dataclasses.replace(spec, mode="shard_map"))
        wrong = dict(gs, embed=(None, None, "model"))
        with pytest.raises(ValueError, match="neither"):
            steps.make_group_train_step(cfg, rc, optim.sgd(0.1),
                                        grad_shardings=wrong,
                                        shard_spec=spec)
        # the hybrid, audio and vlm families, once refused, build their
        # mesh step (tests/test_torch_mesh_families.py runs them)
        for arch in ("zamba2-2.7b", "seamless-m4t-medium", "internvl2-26b"):
            other = configs.get_config(arch).reduced()
            assert callable(steps.make_group_train_step(
                other, rc, optim.sgd(0.1),
                grad_shardings=sharding.gathered_grad_shardings(
                    model.init(0, other, device="cpu"), mesh)))
        # and the codec encodes on a layout spec: on one rank, the
        # unsharded payload
        from repro_torch.core import compression
        codec = compression.get_codec("int8_stochastic")
        spec = sa.layout_spec([(None, None)], tuple(mesh.shape.items()))
        g = torch.randn(2, 3)
        got = codec.encode(g, key=prng.PRNGKey(0), shard_spec=spec)
        want = codec.encode(g, key=prng.PRNGKey(0))
        assert torch.equal(got["q"], want["q"])
        assert torch.equal(got["scale"], want["scale"])


def test_remat_recomputes_under_the_forward_mesh():
    """A remat'd block's backward recomputes it in the context of its
    forward: on the card the autograd engine runs the backward on its
    device thread, which sees no ambient mesh of its own (here a thread
    of ours stands in for it)."""
    import threading

    from repro_torch.models import blocks
    cfg = configs.get_config("minitron-4b").reduced().with_(remat=True)

    def block(x):
        return x * (3.0 if meshctx.current_mesh() is not None else 1.0)

    x = torch.ones(4, requires_grad=True)
    with torch_mesh_ranks.one_rank_mesh():
        y = blocks.maybe_remat(block, cfg)(x)
    got = {}
    thread = threading.Thread(target=lambda: got.update(
        g=torch.autograd.grad(y.sum(), x)[0]))
    thread.start()
    thread.join()
    assert torch.equal(y.detach(), torch.full((4,), 3.0))
    assert torch.equal(got["g"], torch.full((4,), 3.0))


def test_no_unordered_all_reduce_in_the_mesh_step():
    import ast
    import inspect

    from repro_torch.launch import ranks as ranks_mod
    from repro_torch.optim import optimizers
    for mod in (steps, sharding, sa, byzantine, optimizers, ranks_mod,
                aggregators):
        calls = [n.func.attr for n in ast.walk(ast.parse(
            inspect.getsource(mod))) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)]
        assert "all_reduce" not in calls, mod.__name__
