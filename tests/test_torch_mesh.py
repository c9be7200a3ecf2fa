"""The port's model mesh (``models/meshctx.py``, ``launch/mesh.py``,
``launch/sharding.py``) and its four regions against the JAX package.

One module-scoped spawn of 8 gloo ranks (``repro_torch.launch.ranks``)
is the reference's (4, 2) ("data", "model") mesh
(tests/test_parallel_numerics.py) and runs every case twice, with the
reference test's specs, shapes and PRNG keys:

* sequence-parallel attention (d 64, 6 heads, 2 kv heads, hd 16, qkv
  bias, qk norm, x (4, 128, 64), q and kv blocks of 32), causal and with
  a sliding window of 40: forward and gradients;
* expert-parallel MoE (8 experts, top-2, capacity factor 8.0, x (8, 16,
  32)): output, aux and gradients;
* the SP+TP SwiGLU region ((64, 128), x (4, 128, 64)): forward and
  gradients;
* the head-sharded WKV (B 8, T 128, H 4, hd 16);
* loss and gradients of the reduced minitron-4b, h2o-danube-3-4b,
  granite-moe-1b-a400m and rwkv6-7b on (8, 64) tokens.  Granite runs at
  capacity factor 8.0, as the reference's EP case does: expert
  parallelism fills a capacity buffer for each data shard's tokens, so
  where an expert overflows, it drops other assignments than the dense
  layer's buffer for the whole batch (at the config's 1.25 the loss
  moves 1.3e-3), a difference of the reference's own design.

They are held against the reference's dense functions on the same inputs
at the reference test's limits (forward 1e-4, EP 1e-5, gradients 1e-3,
the SwiGLU gradient 1e-4 of max|g|, WKV 1e-3, loss 1e-3), against the
port's own dense path more tightly, and, in one subprocess with 8 virtual
CPU devices, against the reference's own regions under its (4, 2) mesh.
The reference's whole-model case is not run there: on jax 0.9.0 its
layer scan's carry comes back T-sharded and the scan refuses it.  Every
case repeats bit for bit.  The reference's mesh subprocess and its dense
functions run in this process while the ranks do.  The mesh's pieces in
one process (the kernel's offset twins, the sharding specs, one-rank
meshes) are tests/test_torch_mesh_local.py.
"""

import concurrent.futures
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro_torch import configs, convert
from repro_torch.launch import ranks
from repro_torch.models import attention, layers, model, moe, rwkv

import torch_mesh_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, AXES = (4, 2), ("data", "model")
WORLD = 8
WINDOW = 40
MODEL_ARCHS = ("minitron-4b", "h2o-danube-3-4b", "granite-moe-1b-a400m",
               "rwkv6-7b")
# no assignment dropped, in the mesh's buffers or the dense one's
OVERRIDES = {"granite-moe-1b-a400m": {"moe_capacity_factor": 8.0}}
ATTN_SPEC = dict(d_model=64, num_heads=6, num_kv_heads=2, head_dim=16,
                 qkv_bias=True, qk_norm=True)
MOE_SPEC = dict(d_model=32, d_ff=64, num_experts=8, experts_per_token=2,
                capacity_factor=8.0)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else np.asarray(a), tree)


def _jcfg(arch):
    return dataclasses.replace(jget_config(arch).reduced(),
                               **OVERRIDES.get(arch, {}))


def _cfg(arch):
    return configs.get_config(arch).reduced().with_(**OVERRIDES.get(arch, {}))


def _region_inputs():
    """The regions' numpy inputs, drawn with the reference test's keys."""
    key = jax.random.PRNGKey(0)
    cases = {}
    spec = jattention.AttentionSpec(**ATTN_SPEC)
    p = _np(jattention.init(key, spec, dtype=jnp.float32))
    x = _np(jax.random.normal(jax.random.PRNGKey(1), (4, 128, 64)))
    for cid, window in (("attention", None), ("attention_window", WINDOW)):
        cases[cid] = dict(kind="attention",
                          spec=dict(ATTN_SPEC, sliding_window=window),
                          params=p, x=x, q_block=32, kv_block=32)
    mspec = jmoe.MoESpec(**MOE_SPEC)
    cases["moe"] = dict(
        kind="moe", spec=MOE_SPEC,
        params=_np(jmoe.init(key, mspec, dtype=jnp.float32)),
        x=_np(jax.random.normal(jax.random.PRNGKey(2), (8, 16, 32))))
    cases["swiglu"] = dict(
        kind="swiglu",
        params=_np(jlayers.swiglu_init(jax.random.PRNGKey(3), 64, 128,
                                       dtype=jnp.float32)),
        x=_np(jax.random.normal(jax.random.PRNGKey(4), (4, 128, 64))))
    B, T, H, hd = 8, 128, 4, 16
    ks = jax.random.split(jax.random.PRNGKey(5), 5)
    r, k, v = (_np(jax.random.normal(ks[i], (B, T, H, hd)))
               for i in range(3))
    w = _np(jnp.exp(-jnp.exp(jax.random.normal(ks[3], (B, T, H, hd)))))
    cases["wkv"] = dict(
        kind="wkv", r=r, k=k, v=v, w=w,
        u=_np(jax.random.normal(ks[4], (H, hd)) * 0.1),
        state=_np(jax.random.normal(jax.random.PRNGKey(6), (B, H, hd, hd))))
    return cases


def _model_inputs():
    """The reduced models' params (the reference's init) and tokens."""
    cases = {}
    for arch in MODEL_ARCHS:
        cfg = _jcfg(arch)
        cases[f"model/{arch}"] = dict(
            kind="model", arch=arch, overrides=OVERRIDES.get(arch, {}),
            params=_np(jmodel.init(jax.random.PRNGKey(7), cfg)),
            tokens=np.asarray(jax.random.randint(
                jax.random.PRNGKey(8), (8, 64), 0, cfg.vocab_size)))
    return cases


# the reference's four regions under its (4, 2) mesh on the same inputs
REF_MESH = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.models import attention, layers, moe, rwkv
    from repro.models.meshctx import set_mesh

    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    out = {}
    with set_mesh(mesh):
        for cid in ("attention", "attention_window"):
            c = cases[cid]
            spec = attention.AttentionSpec(**c["spec"])
            def sp(p, x):
                return attention.apply_sequence_parallel(
                    p, spec, x, q_block=32, kv_block=32)
            y = jax.jit(sp)(c["params"], c["x"])
            gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(sp(p, x) ** 2),
                                      argnums=(0, 1)))(c["params"], c["x"])
            out[cid] = {"out": y, "grad": gp, "x_grad": gx}
        c = cases["moe"]
        mspec = moe.MoESpec(**c["spec"])
        y, aux = jax.jit(lambda p, x: moe.apply(p, mspec, x))(
            c["params"], c["x"])
        def mloss(p, x):
            o, a = moe.apply(p, mspec, x)
            return jnp.sum(o ** 2) + a
        gp, gx = jax.jit(jax.grad(mloss, argnums=(0, 1)))(c["params"],
                                                          c["x"])
        out["moe"] = {"out": y, "aux": aux, "grad": gp, "x_grad": gx}
        c = cases["swiglu"]
        y = jax.jit(layers.swiglu)(c["params"], c["x"])
        gp, gx = jax.jit(jax.grad(
            lambda p, x: jnp.sum(layers.swiglu(p, x) ** 2),
            argnums=(0, 1)))(c["params"], c["x"])
        out["swiglu"] = {"out": y, "grad": gp, "x_grad": gx}
        c = cases["wkv"]
        y, s = jax.jit(rwkv._wkv_dispatch)(c["r"], c["k"], c["v"], c["w"],
                                           c["u"], c["state"])
        out["wkv"] = {"y": y, "state": s}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, out), f)
""")


@pytest.fixture(scope="module")
def runs():
    """(cases, the 8 ranks' results in rank order, the reference's mesh
    results, the reference's dense results): the reference's mesh
    subprocess and its dense functions in this process run while the
    ranks do."""
    cases = _region_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, "-c", REF_MESH, src, dst],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            cases.update(_model_inputs())
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                spawned = pool.submit(ranks.run, torch_mesh_ranks.run_cases,
                                      WORLD, SHAPE, AXES, cases,
                                      timeout=900.0)
                dense = _reference_dense(cases)
                per_rank = spawned.result()
            _, err = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-4000:]
        with open(dst, "rb") as f:
            ref_mesh = pickle.load(f)
    return cases, per_rank, ref_mesh, dense


def _reference_dense(cases):
    """{case id: the reference's dense result}: attention's output and
    gradients, EP's dense output, aux and gradients, the local SwiGLU's
    output and gradients, each model's loss and gradients."""
    out = {}
    for cid in ("attention", "attention_window"):
        c = cases[cid]
        spec = jattention.AttentionSpec(**c["spec"])
        f = functools.partial(jattention.apply, spec=spec)
        y = jax.jit(lambda p, x: f(p, x=x))(c["params"], c["x"])
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x=x) ** 2),
                                  argnums=(0, 1)))(c["params"], c["x"])
        out[cid] = (np.asarray(y), _flat(_np(gp)), np.asarray(gx))
    c = cases["moe"]
    mspec = jmoe.MoESpec(**MOE_SPEC)
    y, aux = jax.jit(lambda p, x: jmoe._apply_dense(p, mspec, x))(
        c["params"], c["x"])

    def mloss(p, x):
        o, a = jmoe.apply(p, mspec, x)
        return jnp.sum(o ** 2) + a

    gp, gx = jax.jit(jax.grad(mloss, argnums=(0, 1)))(c["params"], c["x"])
    out["moe"] = (np.asarray(y), float(aux), _flat(_np(gp)), np.asarray(gx))
    c = cases["swiglu"]

    def local(p, x):
        return jlayers._swiglu_local(p["w_gate"], p["w_up"], p["w_down"], x)

    y = jax.jit(local)(c["params"], c["x"])
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(local(p, x) ** 2),
                              argnums=(0, 1)))(c["params"], c["x"])
    out["swiglu"] = (np.asarray(y), _flat(_np(gp)), np.asarray(gx))
    for arch in MODEL_ARCHS:
        c = cases[f"model/{arch}"]
        jcfg = _jcfg(arch)
        batch = {"tokens": c["tokens"],
                 "labels": np.roll(c["tokens"], -1, -1)}
        wl, wg = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, b, jcfg)))(c["params"], batch)
        out[f"model/{arch}"] = (float(wl), _flat(_np(wg)))
    return out


# ---------------------------------------------------------------------------
# assembling the ranks' blocks

def _rank(per_rank, d, m):
    return per_rank[d * SHAPE[1] + m]


def _seq_blocks(per_rank, cid, key):
    """The global (B, T, ...) array from the ranks' (B/4, T/2, ...)
    blocks."""
    return torch.cat([torch.cat([_rank(per_rank, d, m)[cid][key]
                                 for m in range(SHAPE[1])], 1)
                      for d in range(SHAPE[0])], 0).numpy()


def _batch_blocks(per_rank, cid, key):
    """The global (B, ...) array from the ranks' (B/4, ...) blocks, the
    same on both model ranks."""
    for d in range(SHAPE[0]):
        assert torch.equal(_rank(per_rank, d, 0)[cid][key],
                           _rank(per_rank, d, 1)[cid][key])
    return torch.cat([_rank(per_rank, d, 0)[cid][key]
                      for d in range(SHAPE[0])], 0).numpy()


def _replicated(per_rank, cid, key):
    """A result every rank holds whole: the same bits on every rank."""
    first = per_rank[0][cid][key]
    for res in per_rank[1:]:
        assert torch.equal(res[cid][key], first), (cid, key)
    return first.numpy()


def _sharded(per_rank, cid, key, model_dim, data_dim=None):
    """A param-shaped result split over model (and data) dims."""
    rows = []
    for d in range(SHAPE[0]):
        rows.append(torch.cat([_rank(per_rank, d, m)[cid][key]
                               for m in range(SHAPE[1])], model_dim))
    if data_dim is None:
        for r in rows[1:]:
            assert torch.equal(r, rows[0]), (cid, key)
        return rows[0].numpy()
    return torch.cat(rows, data_dim).numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _rel_err(a, b):
    return _max_err(a, b) / (float(np.max(np.abs(np.asarray(b)))) + 1e-12)


# ---------------------------------------------------------------------------
# the reference's dense functions and the port's, in this process

def _port_grads(fn, params, x):
    leaves = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
    xt = torch.tensor(x, requires_grad=True)
    out, loss = fn(leaves, xt)
    loss.backward()
    return out.detach().numpy(), _flat(tree_map(lambda t: t.grad.numpy(),
                                                leaves)), xt.grad.numpy()


def _attention_port(case):
    spec = attention.AttentionSpec(**case["spec"])

    def fn(p, x):
        out = attention.apply(p, spec, x)
        return out, torch.sum(out ** 2)

    return _port_grads(fn, case["params"], case["x"])


def _mesh_attention(per_rank, cid, case):
    out = _seq_blocks(per_rank, cid, "out")
    grads = {k: _replicated(per_rank, cid, f"grad/{k}")
             for k in _flat(case["params"])}
    return out, grads, _seq_blocks(per_rank, cid, "x_grad")


@pytest.mark.parametrize("cid", ["attention", "attention_window"])
def test_sp_attention_matches_dense(runs, cid):
    cases, per_rank, _, dense = runs
    out, grads, x_grad = _mesh_attention(per_rank, cid, cases[cid])
    want, wgrads, wx = dense[cid]
    assert _max_err(out, want) < 1e-4, "SP attention fwd"
    for k, g in wgrads.items():
        assert _max_err(grads[k], g) < 1e-3, ("SP attention grad", k)
    assert _max_err(x_grad, wx) < 1e-3
    # the port's dense path: the forward to 1e-6, gradients to 1e-6 of
    # their max (the kv all-gather's transpose sums two ranks' partials)
    pout, pgrads, px = _attention_port(cases[cid])
    assert _max_err(out, pout) < 1e-6
    for k, g in pgrads.items():
        assert _rel_err(grads[k], g) < 1e-6, k
    assert _rel_err(x_grad, px) < 1e-6


@pytest.mark.parametrize("cid", ["attention", "attention_window"])
def test_sp_attention_matches_the_reference_mesh(runs, cid):
    cases, per_rank, ref_mesh, _ = runs
    out, grads, x_grad = _mesh_attention(per_rank, cid, cases[cid])
    ref = ref_mesh[cid]
    assert _max_err(out, ref["out"]) < 1e-4
    for k, g in _flat(ref["grad"]).items():
        assert _max_err(grads[k], g) < 1e-3, k
    assert _max_err(x_grad, ref["x_grad"]) < 1e-3


def _mesh_moe(per_rank, case):
    spec = moe.MoESpec(**case["spec"])
    mesh = types.SimpleNamespace(shape=dict(zip(AXES, SHAPE)),
                                 axis_names=AXES)
    gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(spec, mesh)
    assert fsdp_ok
    grads = {"router": _replicated(per_rank, "moe", "grad/router")}
    for k in ("w_gate", "w_up", "w_down"):
        grads[k] = _sharded(per_rank, "moe", f"grad/{k}", 0,
                            down_ax if k == "w_down" else gate_ax)
    return (_seq_blocks(per_rank, "moe", "out"),
            float(_replicated(per_rank, "moe", "aux")), grads,
            _seq_blocks(per_rank, "moe", "x_grad"))


def test_ep_moe_matches_dense(runs):
    cases, per_rank, _, dense = runs
    case = cases["moe"]
    out, aux, grads, x_grad = _mesh_moe(per_rank, case)
    want, waux, wgrads, gx = dense["moe"]
    assert _max_err(out, want) < 1e-5, "EP fwd"
    assert abs(aux - waux) < 1e-5, "EP aux"
    for k, g in wgrads.items():
        assert _max_err(grads[k], g) < 1e-3, ("EP grad", k)
    assert _max_err(x_grad, gx) < 1e-3
    # the port's dense path: the same bits forward (each token's two
    # expert terms are added once, in either order); aux to an ulp (a
    # mean against a psum'd sum over the token count)
    spec = moe.MoESpec(**MOE_SPEC)

    def fn(p, x):
        o, a = moe._apply_dense(p, spec, x)
        fn.aux = float(a.detach())
        return o, torch.sum(o ** 2) + a

    pout, pgrads, px = _port_grads(fn, case["params"], case["x"])
    assert np.array_equal(out, pout)
    assert abs(aux - fn.aux) <= 1e-6 * abs(fn.aux)
    for k, g in pgrads.items():
        assert _rel_err(grads[k], g) < 1e-6, k
    assert _rel_err(x_grad, px) < 1e-6


def test_ep_moe_matches_the_reference_mesh(runs):
    cases, per_rank, ref_mesh, _ = runs
    out, aux, grads, x_grad = _mesh_moe(per_rank, cases["moe"])
    ref = ref_mesh["moe"]
    assert _max_err(out, ref["out"]) < 1e-5
    assert abs(aux - float(ref["aux"])) < 1e-5
    for k, g in _flat(ref["grad"]).items():
        assert _max_err(grads[k], g) < 1e-3, k
    assert _max_err(x_grad, ref["x_grad"]) < 1e-3


def _mesh_swiglu(per_rank):
    grads = {k: _sharded(per_rank, "swiglu", f"grad/{k}",
                         0 if k == "w_down" else 1)
             for k in ("w_gate", "w_up", "w_down")}
    return (_seq_blocks(per_rank, "swiglu", "out"), grads,
            _seq_blocks(per_rank, "swiglu", "x_grad"))


def test_swiglu_region_matches_local(runs):
    cases, per_rank, _, dense = runs
    case = cases["swiglu"]
    out, grads, x_grad = _mesh_swiglu(per_rank)
    p = case["params"]
    want, wgrads, gx = dense["swiglu"]
    assert _max_err(out, want) < 1e-4, "swiglu fwd"
    for k, g in wgrads.items():
        assert _rel_err(grads[k], g) < 1e-4, ("swiglu grad", k)
    assert _rel_err(x_grad, gx) < 1e-4

    def fn(p, x):
        o = layers.swiglu(p, x)
        return o, torch.sum(o ** 2)

    pout, pgrads, px = _port_grads(fn, p, case["x"])
    assert _max_err(out, pout) < 1e-5
    for k, g in pgrads.items():
        assert _rel_err(grads[k], g) < 1e-5, k
    assert _rel_err(x_grad, px) < 1e-5


def test_swiglu_region_matches_the_reference_mesh(runs):
    _, per_rank, ref_mesh, _ = runs
    out, grads, x_grad = _mesh_swiglu(per_rank)
    ref = ref_mesh["swiglu"]
    assert _max_err(out, ref["out"]) < 1e-4
    for k, g in _flat(ref["grad"]).items():
        assert _rel_err(grads[k], g) < 1e-4, k
    assert _rel_err(x_grad, ref["x_grad"]) < 1e-4


def test_wkv_region_matches_the_scan(runs):
    cases, per_rank, ref_mesh, _ = runs
    c = cases["wkv"]
    y = _batch_blocks(per_rank, "wkv", "y")
    s = _batch_blocks(per_rank, "wkv", "state")
    y_ref, s_ref = jrwkv.wkv_scan(c["r"], c["k"], c["v"], c["w"], c["u"],
                                  c["state"])
    assert _max_err(y, y_ref) < 1e-3, "wkv"
    assert _max_err(s, s_ref) < 1e-3, "wkv state"
    assert _max_err(y, ref_mesh["wkv"]["y"]) < 1e-3
    assert _max_err(s, ref_mesh["wkv"]["state"]) < 1e-3
    # each head's recurrence is the port's wkv_chunked on that head
    yp, sp = rwkv.wkv_chunked(*(torch.tensor(c[n]) for n in
                                ("r", "k", "v", "w", "u", "state")))
    assert np.array_equal(y, yp.numpy()) and np.array_equal(s, sp.numpy())


def _model_grads(per_rank, arch):
    """The mesh gradients assembled to the full params' shapes."""
    cid = f"model/{arch}"
    cfg = _cfg(arch)
    mesh = types.SimpleNamespace(shape=dict(zip(AXES, SHAPE)),
                                 axis_names=AXES)
    out = {}
    for key in per_rank[0][cid]:
        if not key.startswith("grad/"):
            continue
        path = key[5:].split("/")
        if "moe" in path and path[-1] != "router":
            gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(
                moe.MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                            num_experts=cfg.num_experts,
                            experts_per_token=cfg.experts_per_token), mesh)
            ax = down_ax if path[-1] == "w_down" else gate_ax
            out[key[5:]] = _sharded(per_rank, cid, key, 1,
                                    1 + ax if fsdp_ok else None)
        elif "mlp" in path:
            out[key[5:]] = _sharded(per_rank, cid, key,
                                    -2 if path[-1] == "w_down" else -1)
        else:
            out[key[5:]] = _replicated(per_rank, cid, key)
    return out


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_loss_and_gradients_on_the_mesh(runs, arch):
    cases, per_rank, _, dense = runs
    case = cases[f"model/{arch}"]
    loss = float(_replicated(per_rank, f"model/{arch}", "loss"))
    grads = _model_grads(per_rank, arch)
    tok = case["tokens"]
    wl, wgrads = dense[f"model/{arch}"]
    assert abs(loss - wl) < 1e-3, (loss, wl)
    for k, g in wgrads.items():
        assert _max_err(grads[k], g) < 1e-3, k
    # the port in one process: the loss to 1e-5, gradients to 1e-5 of
    # their max
    cfg = _cfg(arch)
    params = tree_map(lambda t: t.requires_grad_(),
                      convert.lm_params_from_numpy(cfg, case["params"],
                                                   "cpu"))
    t = torch.tensor(tok).long()
    pl = model.loss_fn(params, {"tokens": t, "labels": torch.roll(t, -1, -1)},
                       cfg)
    pl.backward()
    assert abs(loss - float(pl.detach())) < 1e-5
    for k, g in _flat(tree_map(lambda t: t.grad.numpy(), params)).items():
        assert _rel_err(grads[k], g) < 1e-5, k


CASE_IDS = ["attention", "attention_window", "moe", "swiglu", "wkv"] + [
    f"model/{a}" for a in MODEL_ARCHS]


@pytest.mark.parametrize("cid", CASE_IDS)
def test_every_case_repeats_bit_for_bit(runs, cid):
    _, per_rank, _, _ = runs
    assert all(res[cid]["repeat_equal"] for res in per_rank)


def test_ranks_sit_row_major_on_the_mesh(runs):
    _, per_rank, _, _ = runs
    for r, res in enumerate(per_rank):
        assert res["coords"] == {"data": r // 2, "model": r % 2}
        assert res["data_index"] == r // 2
