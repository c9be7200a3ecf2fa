"""A rank's block of a sharded random draw, computed alone
(``models/meshctx.py`` ``block_indices``, ``core/shard_aggregation.py``
``draw_block``) and the attacks that draw through it (``random_noise``,
``colluding_mimic``'s direction), against the whole draw cut by
``meshctx.cut`` and against ``jax.random`` of the whole shape.

No ranks: a ``shard_map`` layout reads the ambient mesh's shape and this
rank's coordinates, so a namespace mesh at each coordinate of a (2, 2)
("data", "model") and a (2, 2, 2) ("pod", "data", "model") grid stands
in for the ranks.  The leaves are cut over ``data``, ``model`` and both
(in either order), and one is replicated.
"""

import itertools
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core import byzantine
from repro_torch.core import shard_aggregation as sa
from repro_torch.models import meshctx

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (whole shape, spec of its trailing dims)
LEAVES = [((4, 12, 8), ("data", "model")),
          ((4, 8, 12), (None, ("data", "model"))),
          ((4, 3, 8, 4), (None, ("model", "data"), None)),
          ((4, 6, 8), (None, None)),
          ((4, 8, 7), ("model", None))]
POD_LEAVES = [((4, 16, 8), (("pod", "data"), "model")),
              ((4, 8, 6), ("model", None))]


@pytest.fixture(autouse=True)
def _original_threefry():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _ranks(mesh_name):
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    for c in itertools.product(*(range(n) for n in shape)):
        yield types.SimpleNamespace(shape=sizes, axis_names=axes,
                                    coords=dict(zip(axes, c)))


def _leaves(mesh_name):
    return LEAVES if mesh_name == "2x2" else POD_LEAVES


def _spec(mesh, stacked_spec):
    return sa.layout_spec([stacked_spec], tuple(mesh.shape.items()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_block_indices_name_the_cut(mesh_name):
    """``block_indices`` of a block, all of it or from any position to
    any other, are the flat indices of ``cut``'s elements in its order."""
    for whole, spec in _leaves(mesh_name):
        t = torch.arange(int(np.prod(whole))).reshape(whole)
        for mesh in _ranks(mesh_name):
            block = meshctx.cut(t, spec, mesh.coords, mesh.shape)
            idx = meshctx.block_indices(whole, spec, mesh.coords, mesh.shape)
            assert torch.equal(t.reshape(-1)[idx], block.reshape(-1))
            n = block.numel()
            part = meshctx.block_indices(whole, spec, mesh.coords,
                                         mesh.shape, n // 3, n - 1)
            assert torch.equal(part, idx[n // 3:n - 1])


@pytest.mark.parametrize("chunk", [7, 1 << 22])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_draw_block_is_the_cut_of_the_whole_draw(monkeypatch, mesh_name,
                                                 chunk):
    """Every rank's block of a uniform draw is its cut of the whole draw,
    bit for bit, and of ``jax.random.uniform`` of the whole shape; in
    ``virtual`` mode and without a layout the draw is the whole one."""
    monkeypatch.setattr(prng, "DRAW_CHUNK", chunk)
    key = prng.PRNGKey(4)
    for whole, spec in _leaves(mesh_name):
        want = prng.uniform(key, whole)
        jwant = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), whole))
        np.testing.assert_array_equal(want.numpy().view(np.int32),
                                      jwant.view(np.int32))
        for mesh in _ranks(mesh_name):
            lspec = _spec(mesh, (None,) + spec)
            block = torch.empty(meshctx.cut(want, spec, mesh.coords,
                                            mesh.shape).shape)
            with meshctx.set_mesh(mesh):
                got = sa.draw_block(lspec, block, key, "uniform")
            assert torch.equal(got, meshctx.cut(want, spec, mesh.coords,
                                                mesh.shape))
        virtual = sa.layout_spec([(None,) + spec],
                                 tuple(mesh.shape.items()), mode="virtual")
        assert torch.equal(sa.draw_block(virtual, want, key, "uniform"),
                           want)
        assert torch.equal(sa.draw_block(None, want, key, "uniform"), want)


def test_draw_block_allocates_no_more_than_its_block(monkeypatch):
    """A rank's block of a (4, 64, 64) draw cut over both axes, 100
    positions at a time: no tensor the draw makes holds more than the
    block's 4096 elements."""
    from test_torch_random import _Largest
    monkeypatch.setattr(prng, "DRAW_CHUNK", 100)
    whole, spec = (4, 64, 64), ("data", "model")
    mesh = next(iter(_ranks("2x2")))
    block = torch.empty(4, 32, 32)
    key = prng.PRNGKey(2)
    with meshctx.set_mesh(mesh), _Largest() as seen:
        got = sa.draw_block(_spec(mesh, (None,) + spec), block, key,
                            "normal")
    assert seen.numel <= block.numel()
    assert torch.equal(got, meshctx.cut(prng.normal(key, whole), spec,
                                        mesh.coords, mesh.shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_attacks_draw_only_their_block(mesh_name):
    """``random_noise`` on a layout cut over both axes gives every rank
    its cut of the unsharded attack, bit for bit; ``colluding_mimic``'s
    random direction is the cut of the whole draw's too (its norms are
    blocked sums over the ranks: tests/test_torch_mesh_train.py holds
    that attack's blocks to the virtual oracle on 8 ranks)."""
    rng = np.random.default_rng(3)
    leaves = _leaves(mesh_name)
    grads = {f"w{i}": torch.as_tensor(rng.standard_normal(whole).astype(
        np.float32)) for i, (whole, _) in enumerate(leaves)}
    key = prng.PRNGKey(8)
    mask = torch.tensor([False, True, False, True])
    noise = byzantine.get_attack("random_noise")
    want = noise(grads, mask, key)
    keys = prng.split(key, len(leaves))
    for mesh in _ranks(mesh_name):
        lay = sa.layout_spec([(None,) + s for _, s in leaves],
                             tuple(mesh.shape.items()))
        blocks = {n: meshctx.cut(g, s, mesh.coords, mesh.shape)
                  for (n, g), (_, s) in zip(grads.items(), leaves)}
        with meshctx.set_mesh(mesh), sa.use_layout(lay):
            got = noise(blocks, mask, key)
            for (name, g), (_, s), k, ls in zip(
                    blocks.items(), leaves, keys, sa.leaf_specs(lay, blocks)):
                mu = g[:1]
                direction = sa.draw_block(ls, mu, k, "normal")
                whole = prng.normal(k, (1,) + tuple(grads[name].shape[1:]))
                assert torch.equal(direction, meshctx.cut(
                    whole, s, mesh.coords, mesh.shape)), name
        for name, s in zip(grads, (s for _, s in leaves)):
            assert torch.equal(got[name], meshctx.cut(
                want[name], s, mesh.coords, mesh.shape)), (name, mesh.coords)
