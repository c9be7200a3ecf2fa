"""The pod dry run (``launch/dryrun.py``, ``roofline/``) against the JAX
package, on fake tensors.

* ``steps.input_specs``, ``abstract_params`` and ``abstract_opt_state``
  give the reference's ``ShapeDtypeStruct``s, leaf by leaf by path, for
  every architecture × shape at full size (long_500k's ``+swa4k``
  variant, and the decode state, included).
* The rank's blocks at full size on the (16, 16) and (2, 16, 16) meshes,
  rank 0 and the last rank, against the reference's ``shard_shape`` on a
  ``jax.sharding.AbstractMesh``: params exactly; the optimizer state, the
  train batch and the decode state exactly or, where the port's layout
  differs by design, by bytes or by the named rule.
* The custom ops under a fake ``cuda`` trace: their fakes' shapes and
  types, the flash op's FLOP formula, that registering builds nothing,
  and that a real CPU tensor is refused.
* The roofline: ``model_flops`` for every pair, the record's round trip,
  the table's columns, the collective term's node rule.
* The entry points: ``serve --scale pod``; ``train --scale pod`` (slow).

The dry run against real runs on gloo ranks is
``tests/test_torch_dryrun_ranks.py``."""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import keystr, tree_flatten_with_path
from torch.utils.flop_counter import FlopCounterMode

from repro import optim as joptim
from repro.configs import ARCHITECTURES
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.roofline import analysis as janalysis
from repro_torch import configs, optim
from repro_torch.core.grouping import make_grouping
from repro_torch.kernels import _build
from repro_torch.kernels.attention import flash
from repro_torch.kernels.geomed import round as rk
from repro_torch.launch import dryrun, serve, sharding, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import meshctx
from repro_torch.roofline import analysis

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree) -> dict:
    return {keystr(k): v for k, v in tree_flatten_with_path(tree)[0]}


def _sig(leaves) -> dict:
    """path -> (shape, dtype name) of JAX structs or torch tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# (a) the abstract inputs against the reference's

@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_abstract_specs_match_the_reference(arch):
    mode = FakeTensorMode()
    for name in SHAPES:
        jcfg, jshape, jbatch = jsteps.input_specs(arch, name)
        cfg, shape, batch = steps.input_specs(arch, name, mode=mode)
        assert cfg.name == jcfg.name
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert cfg.sliding_window == jcfg.sliding_window
        if name == "long_500k" and not configs.supports_long_context(
                configs.get_config(arch)):
            assert cfg.name == arch + "+swa4k"
        assert _sig(_tflat(batch)) == _sig(_jflat(jbatch)), (arch, name)
    jparams = jsteps.abstract_params(jcfg)
    params = steps.abstract_params(cfg, mode=mode)
    assert _sig(_tflat(params)) == _sig(_jflat(jparams))
    jopt = jsteps.abstract_opt_state(joptim.adamw(3e-4), jparams)
    opt = steps.abstract_opt_state(optim.adamw(3e-4), params, mode=mode)
    assert _sig(_tflat(opt)) == _sig(_jflat(jopt))
    assert all(t.device.type == "cpu" for t in _tflat(opt).values())


def test_long_context_variant_is_the_reference_rule():
    from repro.configs import get_config as jget
    from repro.configs import long_context_variant as jvariant
    from repro.configs import supports_long_context as jsupports
    for arch in ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jget(arch)
        assert configs.supports_long_context(cfg) == jsupports(jcfg)
        got, want = configs.long_context_variant(cfg), jvariant(jcfg)
        assert (got.name, got.sliding_window) == (want.name,
                                                   want.sliding_window)


# ---------------------------------------------------------------------------
# (b) the rank's blocks against the reference's shard_shape at full size

# optimizer moments whose spec the reference looks up by shape and takes
# from another param of that shape; the port keeps each moment on its own
# param's blocks (``sharding.opt_state_shardings``)
BY_SHAPE_LOOKUP = {
    "rwkv6-7b": ("['time_mix']['wo']", "['time_mix']['ln_x']"),
    "seamless-m4t-medium": ("['layers']['mlp']",),
    "zamba2-2.7b": ("['mamba']['norm']['scale']",)}


def _shard_shapes(structs, shardings) -> dict:
    flat = _jflat(structs)
    return {k: tuple(s.shard_shape(flat[k].shape))
            for k, s in _jflat(shardings).items()}


def _blocks(tree) -> dict:
    return {k: tuple(v.shape) for k, v in _tflat(tree).items()}


def _nbytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in _tflat(tree).values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_blocks_match_the_reference_shard_shapes(mesh_name):
    shape, axes = MESHES[mesh_name]
    amesh = AbstractMesh(shape, axes)
    for arch in ARCHITECTURES:
        for name in SHAPES:
            jcfg, jshape, jbatch = jsteps.input_specs(arch, name)
            jparams = jsteps.abstract_params(jcfg)
            jp = _shard_shapes(jparams, jsharding.param_shardings(
                jparams, amesh, jcfg))
            for rank in (0, math.prod(shape) - 1):
                _check_rank(arch, name, rank, shape, axes, amesh, jcfg,
                            jshape, jbatch, jparams, jp)


def _check_rank(arch, name, rank, shape, axes, amesh, jcfg, jshape, jbatch,
                jparams, jp):
    mode = FakeTensorMode()
    mesh = mesh_lib.make_mesh(shape, axes, rank=rank)
    cfg, ishape, batch = steps.input_specs(arch, name, mode=mode)
    with mode:
        full = steps.abstract_params(cfg, mode=mode)
        specs = sharding.param_shardings(full, mesh, cfg)
        storage = sharding.cut_tree(full, specs, mesh)
        blocks = _blocks(storage)
        assert blocks == jp, (arch, name, rank)
        assert _nbytes(storage) == sum(
            math.prod(s) * np.dtype(_jflat(jparams)[k].dtype).itemsize
            for k, s in jp.items())
        if name == "train_4k":
            jopt = jsteps.abstract_opt_state(joptim.adamw(3e-4), jparams)
            jo = _shard_shapes(jopt, jsharding.opt_state_shardings(
                jopt, jparams, amesh, jcfg))
            opt = optim.adamw(3e-4).init(storage)
            for k, s in _blocks(opt).items():
                if any(part in k for part in BY_SHAPE_LOOKUP.get(arch, ())):
                    # the port's moment is its own param's block
                    assert s == blocks[k[3:]], (arch, k)
                else:
                    assert s == jo[k], (arch, k)
            # the train batch: the reference's rows over the data axes;
            # the port's block also cuts T over model where the stream is
            # sequence-parallel (the Block names those leaves)
            jb = _shard_shapes(jbatch, jsharding.batch_shardings(jbatch,
                                                                 amesh))
            local = sharding.local_train_batch(batch, mesh, cfg)
            for key, t in local.items():
                want = list(jb[f"['{key}']"])
                if key in local.cut:
                    want[2] //= mesh.shape["model"]
                assert tuple(t.shape) == tuple(want), (arch, key)
        if jshape.kind == "decode":
            jstate = jbatch[2]
            js = _shard_shapes(jstate, jsharding.decode_state_shardings(
                jstate, amesh, jcfg, jshape.global_batch))
            block = sharding.local_decode_state(batch[2], mesh, cfg,
                                                ishape.global_batch)
            whole = ishape.global_batch % mesh_lib.data_size(mesh) != 0
            for k, t in _tflat(block).items():
                got = tuple(t.shape)
                if whole:
                    # rows whole on every data rank (``decode_state_specs``):
                    # the reference's rule cuts another dim; the same bytes
                    assert math.prod(got) == math.prod(js[k]), k
                else:
                    assert got == js[k], (arch, name, k)


def test_refused_layouts_name_their_item():
    """A decode state the mesh decode does not take raises by name."""
    mode = FakeTensorMode()
    cfg, shape, (_, _, state) = steps.input_specs(
        configs.get_config("minitron-4b").reduced(),
        configs.base.InputShape("d", 64, 2, "decode"), mode=mode)
    mesh = mesh_lib.make_debug_mesh(data=2, model=2, rank=3)
    with mode, pytest.raises(NotImplementedError, match="16.17"):
        sharding.local_decode_state(state, mesh, cfg, 2)


# ---------------------------------------------------------------------------
# the abstract mesh

def test_abstract_mesh_is_the_real_mesh_rank_view():
    mesh = mesh_lib.make_production_mesh(multi_pod=True, rank=300)
    assert mesh.is_abstract and mesh.rank == 300
    assert mesh.coords == {"pod": 1, "data": 2, "model": 12}
    assert mesh.group("model")[1] == tuple(range(288, 304))
    assert mesh.group(("pod", "data"))[1] == tuple(range(12, 512, 16))
    assert mesh.size("data") == 16 and mesh.index(("pod", "data")) == 18
    assert mesh.axes_of(None) == ("pod", "data", "model")
    assert mesh.axes_of(mesh.group("data")[0]) == ("data",)
    with pytest.raises(ValueError, match="rank 4"):
        mesh_lib.make_debug_mesh(rank=4)
    # a real tensor never passes through the abstract transport
    with pytest.raises(RuntimeError, match="fake tensors only"):
        meshctx.all_gather(torch.ones(2), "model", 0, mesh=mesh)
    with FakeTensorMode():
        x = torch.empty((3, 5))
        with meshctx.set_mesh(mesh):
            g = meshctx.all_gather(x, "model", 1)
            s = meshctx.psum(x, ("pod", "data"))
            r = meshctx.psum_scatter(torch.empty((32, 5)), "model", 0)
            turns = meshctx.one_card_turns(mesh, lambda: 7, "cuda")
    assert (g.shape, s.shape, r.shape, turns) == ((3, 80), (3, 5), (2, 5), 7)
    kinds = mesh.stats["kinds"]
    assert kinds["all_gather"] == dict(calls=1, result_bytes=16 * 60,
                                       wire_bytes=16 * 60)
    assert kinds["psum"] == dict(calls=1, result_bytes=60, wire_bytes=32 * 60)
    assert kinds["psum_scatter"] == dict(calls=1, result_bytes=40,
                                         wire_bytes=640)
    assert mesh.stats["groups"] == {"model": 16 * 60 + 640,
                                    "pod,data": 32 * 60}
    assert mesh.stats["calls"] == 3


# ---------------------------------------------------------------------------
# (d) the kernels' custom ops under a fake cuda trace

ATTN_GRID = [(2, 64, 64, 4, 2, 32, True, None, 0),
             (2, 100, 100, 4, 1, 32, True, None, 0),
             (1, 256, 256, 4, 2, 64, True, 64, 0),
             (2, 64, 64, 4, 4, 32, False, None, 0),
             (2, 333, 333, 8, 2, 120, True, 100, 0),
             (1, 70, 150, 4, 1, 256, False, 50, 0),
             (1, 512, 2048, 32, 8, 120, True, 4096, 1536),
             (1, 256, 1024, 16, 8, 64, True, None, 768),
             (2, 333, 84, 4, 2, 64, False, None, 0)]


def _pairs_by_loop(Tq, Tk, causal, window, offset):
    total = 0
    for q in range(offset, offset + Tq):
        hi = min(q, Tk - 1) if causal else Tk - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


@pytest.mark.parametrize("case", ATTN_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_fake_and_flops(case, dtype):
    B, Tq, Tk, H, KV, hd, causal, window, off = case
    with FakeTensorMode():
        q = torch.empty((B, Tq, H, hd), dtype=dtype, device="cuda")
        k = torch.empty((B, Tk, KV, hd), dtype=dtype, device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = flash.flash_attention(q, k, k, causal=causal,
                                        sliding_window=window, q_offset=off)
    plain = torch.empty((B, Tq, H, hd), dtype=dtype)
    assert (out.shape, out.dtype, out.device.type) == (plain.shape,
                                                       plain.dtype, "cuda")
    pairs = flash.live_pairs(Tq, Tk, causal, window, off)
    assert pairs == _pairs_by_loop(Tq, Tk, causal, window, off)
    assert fc.get_total_flops() == 4 * B * H * hd * pairs


@pytest.mark.parametrize("m,k,d", [(8, 4, 1000), (50, 11, 8192),
                                   (4, 4, 300)])
def test_round_op_fake(m, k, d):
    cached = rk._grouping_tensors.cache_info().currsize
    with FakeTensorMode():
        g = torch.empty((m, d), device="cuda")
        with FlopCounterMode(display=False) as fc:
            y, it = rk.round_aggregate_kernel(g, make_grouping(m, k))
    assert (y.shape, y.dtype, it.shape, it.dtype) == (
        (d,), torch.float32, (), torch.int32)
    assert fc.get_total_flops() == 0
    # a fake trace's grouping tensors never reach the cache a real call
    # reads
    assert rk._grouping_tensors.cache_info().currsize == cached


def test_registering_the_ops_builds_nothing_and_cpu_is_refused():
    assert not _build._LOADED and flash._library.cache_info().currsize == 0
    assert rk._library.cache_info().currsize == 0
    assert hasattr(torch.ops.repro_torch, "flash_attention")
    assert hasattr(torch.ops.repro_torch, "gmom_round")
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_attention(q, q, q, True, None, 0)
    g = torch.zeros((4, 16))
    ints = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.gmom_round(g, ints, ints, torch.ones(4), 1,
                                         3.0, 8, 0.0, 1e-12, 0.0)
    # a fake trace that reached a kernel's library would be refused
    with FakeTensorMode(), pytest.raises(RuntimeError, match="fake trace"):
        _build.load(flash.SOURCE)


# ---------------------------------------------------------------------------
# (e) the roofline

def test_model_flops_match_the_reference():
    from repro.configs import get_config as jget
    from repro.configs import get_shape as jshape
    for arch in ARCHITECTURES:
        for name in SHAPES:
            cfg, shape, _ = steps.input_specs(arch, name)
            jcfg = jsteps.input_specs(arch, name)[0]
            assert analysis.model_flops(cfg, shape) == \
                janalysis.model_flops(jcfg, jshape(name)), (arch, name)


def _record(**kw):
    base = dict(arch="a", shape="train_4k", mesh="16x16", step="train_step",
                flops_per_device=1e12, bytes_per_device=2e9,
                collective_bytes_per_device=3e9,
                collective_breakdown={"psum": {"calls": 2}},
                peak_memory_bytes=5 * 2**30, model_flops_global=1e14,
                num_chips=256, collective_groups={
                    "model": {"wire_bytes": 4.5e9, "bandwidth": 450e9}})
    base.update(kw)
    return analysis.RooflineRecord(**base)


def test_record_round_trip_and_table(tmp_path):
    rec = _record()
    assert rec.compute_term == 1e12 / 989e12
    assert rec.memory_term == 2e9 / 3.35e12
    assert rec.collective_term == 4.5e9 / 450e9
    assert rec.bottleneck == "collective"
    assert rec.useful_flops_ratio == 1e14 / (256 * 1e12)
    path = tmp_path / "r.json"
    analysis.save_records([rec], str(path))
    (back,) = analysis.load_records(str(path))
    assert back == json.loads(json.dumps(rec.to_dict()))
    for key in ("compute_term", "memory_term", "collective_term",
                "bottleneck", "useful_flops_ratio"):
        assert back[key] == getattr(rec, key)
    table = analysis.format_table([rec]).splitlines()
    ref = janalysis.format_table([]).splitlines()
    assert table[:2] == ref[:2]                   # the reference's columns
    assert table[2].split("|")[1:5] == [" a ", " train_4k ", " 16x16 ",
                                        " train_step "]
    assert table[2].split("|")[-2].strip() == "5.00"
    entry = analysis.sweep_entry(rec, scenario="s")
    assert entry["collective_term"] == rec.collective_term


def test_collective_term_reads_the_slowest_link():
    mesh = mesh_lib.make_mesh((4, 8), ("data", "model"), rank=9)
    # a model group is 8 consecutive ranks: one node, NVLink
    assert analysis.link_bandwidth(mesh.group("model")[1]) == 450e9
    # a data group strides over 4 nodes: the network port
    assert analysis.link_bandwidth(mesh.group("data")[1]) == 50e9
    assert analysis.link_bandwidth(range(8, 17)) == 50e9
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    rec = _record(collective_groups={
        "model": {"wire_bytes": 9e9, "bandwidth": 450e9},
        "data": {"wire_bytes": 1e9, "bandwidth": 50e9}})
    assert rec.collective_term == 9e9 / 450e9 + 1e9 / 50e9


# ---------------------------------------------------------------------------
# (f) the entry points

def _reference_param_bytes(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jcfg = jsteps.input_specs(arch, "train_4k")[0]
    jparams = jsteps.abstract_params(jcfg)
    flat = _jflat(jparams)
    return sum(math.prod(s) * np.dtype(flat[k].dtype).itemsize
               for k, s in _shard_shapes(jparams, jsharding.param_shardings(
                   jparams, AbstractMesh(shape, axes), jcfg)).items())


def test_serve_scale_pod(capsys):
    rec = serve.main(["--scale", "pod", "--arch", "h2o-danube-3-4b",
                      "--shape", "decode_32k"])
    assert (rec.arch, rec.shape, rec.mesh, rec.step, rec.rank) == (
        "h2o-danube-3-4b", "decode_32k", "16x16", "serve_step", 0)
    assert rec.params_bytes == _reference_param_bytes("h2o-danube-3-4b",
                                                      "16x16")
    assert rec.flops_per_device > 0 and rec.peak_memory_bytes > \
        rec.params_bytes + rec.inputs_bytes
    assert rec.collective_breakdown["all_gather"]["calls"] > 0
    assert "serve_step) traced in" in capsys.readouterr().out


@pytest.mark.slow
def test_train_scale_pod(capsys):
    from repro_torch.launch import train as train_lib
    rec = train_lib.train(train_lib.parse_args(
        ["--scale", "pod", "--arch", "h2o-danube-3-4b"]))
    assert rec["params_bytes"] == _reference_param_bytes("h2o-danube-3-4b",
                                                         "16x16")
    # AdamW's two f32 moments of the bf16 blocks, and the step count
    assert rec["opt_state_bytes"] == 4 * rec["params_bytes"] + 4
    assert rec["flops_per_device"] > 0
    assert "pod-scale step traced" in capsys.readouterr().out


def test_dryrun_cli_lists_refusals(monkeypatch, capsys):
    """``--all`` records every pair or lists its failure, and exits 1 when
    one fails (each pair here replaced by a stand-in)."""
    calls = []

    def pair(arch, shape, **kw):
        calls.append((arch, shape))
        if shape == "long_500k" and arch == "zamba2-2.7b":
            raise NotImplementedError("ROADMAP Queue 1 item 16.17")
        return _record(arch=arch, shape=shape)

    monkeypatch.setattr(dryrun, "dryrun_pair", pair)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--all"])
    assert exc.value.code == 1
    assert len(calls) == 40
    out = capsys.readouterr().out
    assert "zamba2-2.7b × long_500k: NotImplementedError" in out
    assert out.count("| train_step |") == 39
    records = dryrun.main(["--arch", "qwen2-72b", "--shape", "train_4k"])
    assert [r.arch for r in records] == ["qwen2-72b"]

