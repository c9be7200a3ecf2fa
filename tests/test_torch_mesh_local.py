"""The model mesh's pieces in one process, against the JAX package.

* The flash kernel's plain twins at a query offset
  (``ref.flash_attention_ref``, ``ref.flash_attention_tiled_ref``) and
  the port's ``attention._online_softmax_attention`` against the
  reference's ``_online_softmax_attention`` with the same query
  positions, and an offset block against the matching rows of a longer
  one.
* ``launch/sharding.py``'s specs against the reference's rules for every
  architecture (reduced and full) on (16, 16), (2, 16, 16) and (4, 2)
  meshes (the reference reads only ``mesh.shape`` and
  ``mesh.axis_names``, so a namespace stands in for its mesh), and
  ``local_params`` on a one-rank mesh.
* The mesh objects on a one-rank gloo group of this process: the groups'
  registry that ``core.shard_aggregation`` reads, the collectives, the
  hybrid, audio and vlm families on a one-rank mesh (prefill above and
  below the sequence-parallel threshold, decode on the state's blocks),
  and no unordered ``all_reduce`` in the mesh code.

The 8-rank regions and models are tests/test_torch_mesh.py."""

import ast
import functools
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro.configs import ARCHITECTURES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.core import shard_aggregation as sa
from repro_torch.kernels.attention import ref as kref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import (attention, layers, mamba, meshctx, model,
                                moe, rwkv)

import torch_mesh_ranks


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


# ---------------------------------------------------------------------------
# the flash kernel's plain twins at a query offset

@pytest.mark.parametrize("causal,window,offset", [
    (True, None, 0), (True, None, 64), (True, 40, 64), (True, 40, 96),
    (False, None, 32), (True, 100, 37)])
def test_offset_twins_match_the_reference_online_softmax(causal, window,
                                                         offset):
    rng = np.random.default_rng(offset + (window or 0))
    B, Tq, Tk, H, KV, hd = 2, 32, 128, 6, 2, 16
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Tk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Tk, KV, hd)).astype(np.float32)
    q_pos = jnp.broadcast_to(jnp.arange(offset, offset + Tq)[None], (B, Tq))
    want = np.asarray(jattention._online_softmax_attention(
        q, k, v, causal=causal, window=window, q_pos=q_pos, kv_block=32,
        kv_len=None))
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    got = kref.flash_attention_ref(qt, kt, vt, causal=causal,
                                   sliding_window=window, q_offset=offset)
    tiled = kref.flash_attention_tiled_ref(qt, kt, vt, causal=causal,
                                           sliding_window=window,
                                           q_offset=offset)
    online = attention._online_softmax_attention(
        qt, kt, vt, causal=causal, window=window,
        q_pos=torch.tensor(np.asarray(q_pos)), kv_block=32)
    for name, t in (("ref", got), ("tiled", tiled), ("online", online)):
        assert _max_err(t.numpy(), want) < 2e-6, name
    # offset rows are the matching rows of the unshifted call on a longer
    # query block
    if offset + Tq <= Tk:
        qlong = torch.zeros((B, offset + Tq, H, hd))
        qlong[:, offset:] = qt
        full = kref.flash_attention_ref(qlong, kt, vt, causal=causal,
                                        sliding_window=window)
        assert _max_err(full[:, offset:].numpy(), got.numpy()) < 1e-6


# ---------------------------------------------------------------------------
# launch/sharding.py against the reference's rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _ns_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), path, leaf) for path, leaf in flat]


def _lookup(tree, names):
    for n in names:
        tree = tree[int(n) if isinstance(tree, (tuple, list)) else n]
    return tree


@functools.cache
def _configs(arch, scale):
    """The reference's and the port's config and the reference's param
    shapes (``eval_shape`` of its init)."""
    jcfg, cfg = jget_config(arch), configs.get_config(arch)
    if scale == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return jcfg, cfg, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("scale", ["reduced", "full"])
def test_param_specs_match_the_reference(mesh_name, scale):
    mesh = _ns_mesh(mesh_name)
    for arch in ARCHITECTURES:
        jcfg, cfg, shapes = _configs(arch, scale)
        specs = sharding.param_shardings(shapes, mesh, cfg)
        stacked = sharding.stacked_grad_shardings(shapes, mesh, cfg)
        for names, path, leaf in _paths(shapes):
            want = tuple(jsharding.param_partition_spec(path, leaf, mesh,
                                                        jcfg))
            want = want + (None,) * (leaf.ndim - len(want))
            assert _lookup(specs, names) == want, (arch, names)
            assert _lookup(stacked, names) == (None,) + want
            bare = tuple(jsharding.param_partition_spec(
                path, leaf, mesh, jcfg, fsdp=False))
            assert sharding.param_partition_spec(
                names, leaf, mesh, cfg, fsdp=False) == \
                bare + (None,) * (leaf.ndim - len(bare))
        assert sharding.storage_axes(cfg, mesh) == \
            jsharding.storage_axes(jcfg, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_state_and_grad_specs_match_the_reference(mesh_name):
    mesh = _ns_mesh(mesh_name)
    assert sharding.train_batch_spec(mesh) == tuple(
        jsharding.train_batch_spec(mesh))
    for b in (1, 4, 64, 96):
        assert sharding.serve_batch_spec(mesh, b) == tuple(
            jsharding.serve_batch_spec(mesh, b))
    for arch in ARCHITECTURES:
        jcfg, cfg, _ = _configs(arch, "reduced")
        for batch in (2, 32):
            state = jax.eval_shape(lambda: jmodel.init_decode_state(
                jcfg, batch, 64))
            got = sharding.decode_state_shardings(state, mesh, cfg, batch)
            want = _ref_state_specs(state, mesh, jcfg, batch)
            for names, _, leaf in _paths(state):
                w = _lookup(want, names).spec
                w = w + (None,) * (leaf.ndim - len(w))
                assert _lookup(got, names) == w, (arch, batch, names)
        spec = sharding.grad_shard_spec(mesh, cfg)
        jspec = jsharding.grad_shard_spec(mesh, jcfg)
        assert (spec.num_shards, spec.mode, spec.axis) == \
            (jspec.num_shards, jspec.mode, jspec.axis)


def _ref_state_specs(state, mesh, jcfg, batch):
    """The reference's decode-state specs, without its NamedSharding (the
    namespace mesh has no devices): its rule replayed through a stand-in
    that keeps the spec."""
    real = jsharding.NamedSharding
    jsharding.NamedSharding = lambda _mesh, spec: types.SimpleNamespace(
        spec=tuple(spec))
    try:
        return jsharding.decode_state_shardings(state, mesh, jcfg, batch)
    finally:
        jsharding.NamedSharding = real


def test_local_params_cut_the_regions_layout():
    """local_params on a (1, 1) mesh is the identity; on the (4, 2) ranks
    it is the layout the model tests above assemble from (their
    gradients have the cut shapes)."""
    cfg = configs.get_config("granite-moe-1b-a400m").reduced()
    params = model.init(0, cfg, device="cpu")
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        local = sharding.local_params(params, mesh, cfg)
    assert _flat(tree_map(lambda t: t.shape, local)).keys() == \
        _flat(tree_map(lambda t: t.shape, params)).keys()
    for k, t in _flat(tree_map(lambda t: t.numpy(), local)).items():
        assert np.array_equal(t, _flat(tree_map(lambda t: t.numpy(),
                                                params))[k]), k


# ---------------------------------------------------------------------------
# the mesh objects on a one-rank group of this process

def test_mesh_construction_and_its_one_registry():
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coords == {"data": 0, "model": 0}
        assert meshctx.current_mesh() is mesh
        assert meshctx.sp_applicable(mesh, 2, 16)
        assert not meshctx.sp_applicable(mesh, 2, 15)
        assert meshctx.dspec(mesh) == "data"
        assert meshctx.constrain("x", ("data",)) == "x"
        with pytest.raises(ValueError, match="holds 4 ranks"):
            mesh_lib.make_mesh((2, 2), ("data", "model"))
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_lib.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 ranks"):
            mesh_lib.make_production_mesh(multi_pod=True)
        # shard_aggregation reads the mesh's group for its axis, and
        # refuses a second binding of it
        spec = sa.ShardSpec(num_shards=1, mode="shard_map", axis="model")
        assert sa.shard_group(spec) is mesh.group("model")[0]
        other = dist.new_group([0])
        with pytest.raises(ValueError, match="ambient mesh"):
            with sa.axis_group("model", other):
                pass
        with sa.axis_group("pod", other):
            assert meshctx.axis_group_of("pod") is other
        assert meshctx.axis_group_of("pod") is None
    assert meshctx.current_mesh() is None


def test_collectives_on_one_rank_are_the_identity():
    x = torch.randn(2, 4, requires_grad=True)
    with torch_mesh_ranks.one_rank_mesh():
        y = meshctx.all_gather(x, "model", 1)
        y = meshctx.psum_scatter(y, ("data", "model"), 0)
        y = meshctx.psum(meshctx.pvary(y, "data"), "data")
        (y * 3).sum().backward()
    assert torch.equal(y, x)
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


def test_no_unordered_all_reduce_in_the_mesh_code():
    """Every cross-rank sum of the mesh path is gathered and added in rank
    order: no call of ``all_reduce`` in its modules."""
    for mod in (meshctx, mesh_lib, sharding, attention, layers, moe, rwkv,
                mamba, model):
        calls = [n.func.attr for n in ast.walk(ast.parse(
            inspect.getsource(mod))) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)]
        assert "all_reduce" not in calls, mod.__name__


def _family_batch(cfg, T, extra=16):
    batch = {"tokens": torch.zeros((1, T), dtype=torch.long)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((1, extra, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = torch.randn((1, extra, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium",
                                  "internvl2-26b"])
def test_unported_families_raise_under_a_mesh(arch):
    """The hybrid, audio and vlm families, once refused under a mesh, run
    there: on a one-rank mesh the sequence-parallel forward, the forward
    below the threshold (T = 4), each on its ``sharding.local_batch``
    block, and two decode steps on the state's block
    (``sharding.local_decode_state``) compute what one process does."""
    cfg = configs.get_config(arch).reduced()
    params = model.init(0, cfg, device="cpu")

    def close(got, want):
        return float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())

    def decode(state):
        out = []
        for t in range(2):
            logits, _ = model.decode_step(
                params, cfg, state, torch.full((1, 1), 7 + t),
                torch.full((1,), t))
            out.append(logits)
        return torch.cat(out, 1)

    long, short = _family_batch(cfg, 32), _family_batch(cfg, 4, extra=4)
    want = [model.forward(params, cfg, b)[0] for b in (long, short)]
    want.append(decode(model.init_decode_state(cfg, 1, 8, device="cpu")))
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        got = [model.forward(params, cfg,
                             sharding.local_batch(b, mesh, cfg))[0]
               for b in (long, short)]
        got.append(decode(sharding.local_decode_state(
            model.init_decode_state(cfg, 1, 8, device="cpu"), mesh, cfg, 1)))
    assert all(close(g, w) for g, w in zip(got, want))
