"""The port's pod sweep (``repro_torch.sim.sweep``) against the JAX
package's (``repro.sim.sweep``), on the CPU.

* the registry: the same 101 cell names; each ``PodScenario``'s fields,
  its ``RobustConfig`` and its schedule the reference's; every constant
  and tuple the reference's;
* the gates: the reference's doctored payloads (its tests' ``_fake_entry``
  shapes, the breakdown translated to the port's per-kind
  ``result_bytes``) flag the same scenarios and fields under both
  packages' ``compare_payloads``, ``shard_scaling_problems`` and
  ``compression_wire_problems``;
* the CLI: ``--check --fresh-from`` exits 0, 1 and 2, and a filtered
  ``--single-pod`` check calls nothing stale;
* small lowerings: the reference's own test cell on an abstract (2, 2, 2)
  mesh at reduced minitron, a wire and a stale microcell on an abstract
  (1, 4) mesh; each wire cell's collective bytes are its gathered
  payload's;
* the microcells' outputs at small d, inputs drawn from a seed with numpy:
  the port's unsharded functions (which the ranks' outputs equal,
  ``tests/test_torch_dryrun_ranks.py``) against the reference's int8
  encode bit for bit and its ``aggregate_reported`` (after
  ``merge_reports`` for the stale cells) within ``compare_traces``'
  tolerances;
* the checked-in record ``src/repro_torch/sim/pod_sweeps.json`` covers
  the registry on both meshes, nothing stale, and passes the gates.
"""

import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcompression
from repro.core import staleness as jstaleness
from repro.core.robust_train import aggregate_reported as jaggregate_reported
from repro.roofline import analysis as janalysis
from repro.sim import sweep as jsweep
from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis
from repro_torch.sim import goldens
from repro_torch.sim import sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


# ---------------------------------------------------------------------------
# the registry

CONSTANTS = ("POD_ATTACKS", "POD_SCHEDULES", "POD_AGGREGATORS", "POD_MESHES",
             "MESH_MULTI_POD", "DEFAULT_ARCH", "DEFAULT_SHAPE",
             "RTOL_COLLECTIVE", "RTOL_MEMORY", "ATOL_BYTES",
             "BIG_MODEL_ARCH", "BIG_MODEL_SCENARIOS",
             "WIRE_REDUCTION_MIN_SIGN", "WIRE_REDUCTION_MIN_INT8",
             "WIRE_RTOL", "WIRE_BASELINE_SCENARIO", "WIRE_SIGN_SCENARIO",
             "WIRE_INT8_SCENARIO", "COMPRESSION_SCENARIOS", "STALE_ARRIVAL",
             "STALE_BOUND", "STALE_SHARDED_SCENARIO",
             "STALE_GATHERED_SCENARIO", "STALE_SCENARIOS",
             "SHARD_MEMORY_MIN_RATIO", "KRUM_PEAK_MAX_RATIO")


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_are_the_references(name):
    assert getattr(sweep, name) == getattr(jsweep, name)


def test_registry_names_are_the_references():
    assert sweep.available() == jsweep.available()
    assert len(sweep.available()) == 101


def test_every_cell_its_config_and_schedule_are_the_references():
    for name in jsweep.available():
        ps, ref = sweep.get_pod_scenario(name), jsweep.get_pod_scenario(name)
        assert dataclasses.asdict(ps) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(ps.robust_config()) == \
            dataclasses.asdict(ref.robust_config()), name
        got, want = ps.build_schedule(), ref.build_schedule()
        assert (got.name, got.num_workers, got.num_byzantine) == \
            (want.name, want.num_workers, want.num_byzantine), name
        g = jtree.leaves(got.init_state(torch.device("cpu")))
        w = jax.tree.leaves(want.init_state())
        assert [x.tolist() for x in g] == [np.asarray(x).tolist()
                                           for x in w], name


def test_registry_rejects_unknown_and_duplicate():
    with pytest.raises(KeyError, match="unknown pod scenario"):
        sweep.get_pod_scenario("pod/nope")
    with pytest.raises(ValueError, match="already registered"):
        sweep.register(sweep.get_pod_scenario(sweep.available()[0]))
    with pytest.raises(ValueError, match="unknown mesh"):
        sweep.register(sweep.PodScenario(name="pod/bad-mesh", mesh="3x3"))


# ---------------------------------------------------------------------------
# the gates, on the reference's doctored payloads

KINDS = {"all-gather": "all_gather", "all-reduce": "psum"}


def _fake_pair(name, *, coll=1.0e9, peak=2.0e9):
    """The reference tests' ``_fake_entry`` in both packages' schemas."""
    rec = janalysis.RooflineRecord(
        arch="minitron-4b", shape="train_4k", mesh="16x16",
        step="train_step", flops_per_device=1e12, bytes_per_device=1e12,
        collective_bytes_per_device=coll,
        collective_breakdown={"all-gather": coll * 0.5,
                              "all-reduce": coll * 0.5},
        peak_memory_bytes=peak, model_flops_global=1e15, num_chips=256)
    ref = janalysis.sweep_entry(rec, scenario=name)
    ref.update(aggregator="gmom", attack="sign_flip", schedule="static",
               round_backend="auto", num_groups=4, num_byzantine=1,
               compile_seconds=1.0)
    port = analysis.sweep_entry(analysis.RooflineRecord(
        arch="minitron-4b", shape="train_4k", mesh="16x16",
        step="train_step", flops_per_device=1e12, bytes_per_device=1e12,
        collective_bytes_per_device=coll,
        collective_breakdown={
            KINDS[op]: dict(calls=1, result_bytes=b, wire_bytes=b)
            for op, b in rec.collective_breakdown.items()},
        peak_memory_bytes=peak, model_flops_global=1e15, num_chips=256),
        scenario=name)
    port.update(aggregator="gmom", attack="sign_flip", schedule="static",
                round_backend="auto", num_groups=4, num_byzantine=1,
                trace_seconds=1.0, rank=0)
    return ref, port


def _payloads(entries: dict) -> tuple[dict, dict]:
    """{name: kw} -> (the reference's payload, the port's)."""
    pairs = {n: _fake_pair(n, **kw) for n, kw in entries.items()}
    return ({"scenarios": {n: p[0] for n, p in pairs.items()}},
            {"scenarios": {n: p[1] for n, p in pairs.items()}})


def _scale(payloads, name, field, factor):
    """The same doctoring in both schemas (a breakdown scales each kind's
    bytes)."""
    for p in payloads:
        e = p["scenarios"][name]
        if field == "collective_breakdown":
            for op, v in e[field].items():
                if isinstance(v, dict):
                    v["result_bytes"] *= factor
                    v["wire_bytes"] *= factor
                else:
                    e[field][op] = v * factor
        else:
            e[field] *= factor


def _flags(lines):
    """What a gate flagged: (scenario or gate, which field) per line."""
    out = []
    for line in lines:
        head = line.split(":")[0]
        what = next((w for w in ("collective bytes", "peak memory",
                                 "not in the checked-in record",
                                 "stale record entry", "bytes moved",
                                 "O(d/shards)", "krum", "optimized away",
                                 "sign", "int8") if w in line), line)
        out.append((head.replace("compiled peak", "peak"), what))
    return sorted(out)


def _compare_both(record, fresh):
    jp, jn = jsweep.compare_payloads(record[0], fresh[0])
    tp, tn = sweep.compare_payloads(record[1], fresh[1])
    return (_flags(jp), _flags(jn)), (_flags(tp), _flags(tn))


NAMES = jsweep.available()


def _doctored(case):
    """(record, fresh) pairs, in both schemas, of one gate case."""
    if case == "clean":
        rec = _payloads({n: {} for n in NAMES[:3]})
        return rec, copy.deepcopy(rec)
    if case == "missing_and_stale":
        return (_payloads({NAMES[0]: {}}), _payloads({NAMES[1]: {}}))
    rec = _payloads({n: {} for n in NAMES[:2]})
    fresh = copy.deepcopy(rec)
    if case == "collective_regression":
        _scale(fresh, NAMES[0], "collective_bytes_per_device", 1.5)
    elif case == "memory_regression_and_improvement":
        _scale(fresh, NAMES[0], "peak_memory_bytes", 2.0)
        _scale(fresh, NAMES[0], "collective_bytes_per_device", 0.5)
    elif case == "drift_within_tolerance":
        _scale(fresh, NAMES[0], "collective_bytes_per_device", 1.01)
        _scale(fresh, NAMES[0], "peak_memory_bytes", 1.05)
    elif case == "breakdown_drift":
        _scale(fresh, NAMES[1], "collective_breakdown", 1.5)
    return rec, fresh


@pytest.mark.parametrize("case", [
    "clean", "collective_regression", "memory_regression_and_improvement",
    "missing_and_stale", "drift_within_tolerance", "breakdown_drift"])
def test_compare_payloads_flags_what_the_reference_flags(case):
    record, fresh = _doctored(case)
    ref, port = _compare_both(record, fresh)
    assert port == ref
    if case in ("collective_regression", "missing_and_stale",
                "memory_regression_and_improvement"):
        assert port[0]
    if case == "breakdown_drift":
        assert port[1] and not port[0]


def _big(*, gmom_peak=1.0e10, gathered_peak=None, krum_peak=None):
    base = f"pod/16x16/{sweep.BIG_MODEL_ARCH}/gmom/sign_flip/static"
    krum = f"pod/16x16/{sweep.BIG_MODEL_ARCH}/krum/sign_flip/static"
    gathered_peak = (gmom_peak * sweep.SHARD_MEMORY_MIN_RATIO * 2
                     if gathered_peak is None else gathered_peak)
    krum_peak = gmom_peak * 1.1 if krum_peak is None else krum_peak
    return _payloads({base: dict(peak=gmom_peak),
                      base + "/gathered": dict(peak=gathered_peak),
                      krum: dict(peak=krum_peak)})


def _wire(*, f32=8.0e10, sign=None, int8=None):
    return _payloads({
        sweep.WIRE_BASELINE_SCENARIO: dict(coll=f32),
        sweep.WIRE_SIGN_SCENARIO: dict(coll=f32 / 32.0 if sign is None
                                       else sign),
        sweep.WIRE_INT8_SCENARIO: dict(coll=f32 / 4.0 if int8 is None
                                       else int8)})


def _optimized_away():
    both = _wire()
    for p in both:
        p["scenarios"][sweep.WIRE_SIGN_SCENARIO][
            "collective_bytes_per_device"] = 0.0
    return both


GATE_CASES = {
    "big_clean": lambda: _big(),
    "lost_memory_ratio": lambda: _big(
        gathered_peak=1.0e10 * (sweep.SHARD_MEMORY_MIN_RATIO - 1)),
    "krum_blowup": lambda: _big(
        krum_peak=1.0e10 * (sweep.KRUM_PEAK_MAX_RATIO + 1)),
    "big_absent": lambda: _payloads({n: {} for n in NAMES[:2]}),
    "wire_clean": lambda: _wire(),
    "lost_sign_reduction": lambda: _wire(sign=8.0e10 / 20.0),
    "lost_int8_reduction": lambda: _wire(int8=8.0e10 / 2.0),
    "inside_wire_rtol": lambda: _wire(sign=8.0e10 / (25.0 * (1 - 0.04))),
    "optimized_away_wire": _optimized_away,
    "wire_absent": lambda: ({"scenarios": {}}, {"scenarios": {}}),
    "wire_base_only": lambda: tuple(
        {"scenarios": {sweep.WIRE_BASELINE_SCENARIO:
                       p["scenarios"][sweep.WIRE_BASELINE_SCENARIO]}}
        for p in _wire()),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_scaling_and_wire_gates_flag_what_the_reference_flags(case):
    ref, port = GATE_CASES[case]()
    for jgate, tgate in ((jsweep.shard_scaling_problems,
                          sweep.shard_scaling_problems),
                         (jsweep.compression_wire_problems,
                          sweep.compression_wire_problems)):
        want = _flags(jgate(ref["scenarios"]))
        assert _flags(tgate(port["scenarios"])) == want
    flagged = (sweep.shard_scaling_problems(port["scenarios"])
               + sweep.compression_wire_problems(port["scenarios"]))
    assert bool(flagged) == (case in ("lost_memory_ratio", "krum_blowup",
                                      "lost_sign_reduction",
                                      "lost_int8_reduction",
                                      "optimized_away_wire"))


# ---------------------------------------------------------------------------
# the CLI

def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.sweep", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))


def test_cli_check_exit_codes(tmp_path):
    """--check --fresh-from: a clean record -> 0, a doctored regression ->
    1, no record -> 2; nothing is traced."""
    fresh = _payloads({n: {} for n in NAMES[:2]})[1]
    fresh_path = tmp_path / "fresh.json"
    fresh_path.write_text(json.dumps(fresh))
    ok_record = tmp_path / "record_ok.json"
    ok_record.write_text(json.dumps(fresh))
    bad = copy.deepcopy(fresh)
    bad["scenarios"][NAMES[0]]["collective_bytes_per_device"] *= 0.5
    bad_record = tmp_path / "record_bad.json"
    bad_record.write_text(json.dumps(bad))
    for record, code in ((ok_record, 0), (bad_record, 1),
                         (tmp_path / "missing.json", 2)):
        res = _run("--check", "--fresh-from", str(fresh_path),
                   "--record-path", str(record))
        assert res.returncode == code, (res.stdout, res.stderr[-2000:])
        if code == 1:
            assert "REGRESSION" in res.stdout


def test_cli_filtered_check_ignores_out_of_scope_record_entries(tmp_path):
    single = [n for n in NAMES
              if sweep.get_pod_scenario(n).mesh == "16x16"][:2]
    multi = [n for n in NAMES
             if sweep.get_pod_scenario(n).mesh == "2x16x16"][:2]
    record_path = tmp_path / "record.json"
    record_path.write_text(json.dumps(
        _payloads({n: {} for n in single + multi})[1]))
    fresh_path = tmp_path / "fresh.json"
    fresh_path.write_text(json.dumps(_payloads({n: {} for n in single})[1]))
    code = sweep.main(["--check", "--single-pod", "--scenario", single[0],
                       "--scenario", single[1], "--fresh-from",
                       str(fresh_path), "--record-path", str(record_path)])
    assert code == 0


# ---------------------------------------------------------------------------
# small lowerings

SMALL = InputShape("train_tiny", seq_len=32, global_batch=16, kind="train")


def test_reference_test_cell_lowers_on_small_mesh():
    """The reference's own small-mesh case, on rank 0's view of an
    abstract (2, 2, 2) mesh, reduced minitron."""
    ps = sweep.get_pod_scenario(
        f"pod/2x16x16/{sweep.DEFAULT_ARCH}/gmom/alie/stealth_then_strike")
    entry = sweep.lower_scenario(
        ps, mesh=mesh_lib.make_debug_mesh(data=2, model=2, pod=2, rank=0),
        cfg=get_config(sweep.DEFAULT_ARCH).reduced(), shape=SMALL,
        device="cpu")
    assert entry["scenario"] == ps.name and entry["num_chips"] == 8
    assert entry["step"] == "train_step" and entry["rank"] == 0
    assert entry["collective_bytes_per_device"] > 0
    assert set(entry["collective_breakdown"]) == {
        "all_gather", "psum", "psum_scatter", "all_to_all"}
    assert json.loads(json.dumps(entry)) == entry


def _line(rank=1):
    return mesh_lib.make_mesh((1, 4), ("data", "model"), rank=rank)


@pytest.mark.parametrize("name", [sweep.WIRE_INT8_SCENARIO,
                                  sweep.STALE_SHARDED_SCENARIO])
def test_microcell_lowers_on_small_mesh(name):
    ps = sweep.get_pod_scenario(name)
    cfg = get_config(sweep.DEFAULT_ARCH).reduced()
    entry = sweep.lower_any(ps, mesh=_line(), cfg=cfg, shape=SMALL,
                            device="cpu")
    assert entry["step"] == ("report_wire" if ps.wire else "stale_report")
    assert entry["rank"] == 1 and entry["num_chips"] == 4
    assert entry["collective_bytes_per_device"] > 0
    assert json.loads(json.dumps(entry)) == entry
    if ps.stale:
        assert (entry["arrival"], entry["staleness_bound"]) == \
            (sweep.STALE_ARRIVAL, sweep.STALE_BOUND)


def _payload_bytes(ps, d, m=4, ranks=4):
    """The bytes a rank receives on the wire: the gathered cut payload
    (the f32 report, the packed sign words, the int8 q), and for int8
    the per-row maxima its unsharded scales are made of, from every rank
    of the mesh."""
    return {"none": 4 * m * d, "sign": m * d // 8,
            "int8_stochastic": m * d + ranks * 4 * m}[ps.compression]


@pytest.mark.parametrize("name", [sweep.WIRE_BASELINE_SCENARIO,
                                  sweep.WIRE_SIGN_SCENARIO,
                                  sweep.WIRE_INT8_SCENARIO])
def test_wire_cell_bytes_are_its_gathered_payloads(name):
    ps = sweep.get_pod_scenario(name)
    d = 1 << 12
    rec = sweep.trace_microcell(ps, mesh=_line(), d_pad=d,
                                device="cpu").record
    assert rec.collective_bytes_per_device == _payload_bytes(ps, d)
    gathers = rec.collective_breakdown["all_gather"]["calls"]
    assert gathers == (2 if ps.compression == "int8_stochastic" else 1)
    # the payload the unsharded function builds: the same bytes
    out = sweep.run_microcell(ps, None, d, 5, device="cpu")
    leaves = [x for x in torch.utils._pytree.tree_leaves(out["payload"])
              if x.ndim >= 2]
    cut = sum(x.numel() * x.element_size() for x in leaves)
    assert cut == {"none": 4 * 4 * d, "sign": 4 * d // 8,
                   "int8_stochastic": 4 * d}[ps.compression]


# the microcells whose consume is whole ``gmom`` (the int8 wire's
# ``int8_gmom`` decodes into it); the sign wire's rule is not gmom and
# the sharded stale cell's aggregation is partitioned over ``model``
WHOLE_GMOM = (sweep.WIRE_BASELINE_SCENARIO, sweep.WIRE_INT8_SCENARIO,
              sweep.STALE_GATHERED_SCENARIO)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("name", [sweep.WIRE_BASELINE_SCENARIO,
                                  sweep.WIRE_SIGN_SCENARIO,
                                  sweep.WIRE_INT8_SCENARIO,
                                  *sweep.STALE_SCENARIOS])
def test_microcell_trace_takes_the_round_kernel_for_cuda(name, device):
    """A microcell traced for ``cuda`` takes the card's path whether or
    not this host has one: each whole-``gmom`` consume reaches the round
    kernel's op once (by its fake), as the real run on the card launches
    the kernel once a rank; traced for the CPU it reaches none."""
    art = sweep.trace_microcell(sweep.get_pod_scenario(name), mesh=_line(),
                                d_pad=1 << 12, device=device)
    calls = art.ops.get("repro_torch::gmom_round", {"calls": 0})["calls"]
    assert calls == (1 if device == "cuda" and name in WHOLE_GMOM else 0)


@pytest.mark.parametrize("name", [sweep.WIRE_BASELINE_SCENARIO,
                                  sweep.WIRE_SIGN_SCENARIO,
                                  sweep.WIRE_INT8_SCENARIO,
                                  *sweep.STALE_SCENARIOS])
def test_microcell_peak_does_not_wait_for_the_collector(name):
    """A microcell's traced peak is the same whether the garbage
    collector never runs or runs at every allocation: no fake tensor
    lives in a reference cycle, so the record does not depend on what
    the process traced before (the int8 wire's payload block, once)."""
    mesh = mesh_lib.make_mesh((16, 16), ("data", "model"), rank=0)
    ps = sweep.get_pod_scenario(name)
    threshold = gc.get_threshold()
    peaks = []
    for eager in (False, True):
        gc.collect()
        if eager:
            gc.set_threshold(1)
        else:
            gc.disable()
        try:
            peaks.append(sweep.trace_microcell(
                ps, mesh=mesh, d_pad=1 << 12).record.peak_memory_bytes)
        finally:
            gc.enable()
            gc.set_threshold(*threshold)
    assert peaks[0] == peaks[1]


# ---------------------------------------------------------------------------
# the microcells' outputs against the reference

D_SMALL = 1 << 10
SEED = 31


def _ref_inputs(ps):
    inputs = sweep.microcell_inputs(ps, D_SMALL, SEED)
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            jax.random.PRNGKey(SEED))


def _close(got, want):
    return goldens.compare_traces(
        {"y": np.asarray(got, np.float64).ravel().tolist()},
        {"y": np.asarray(want, np.float64).ravel().tolist()})


@pytest.mark.parametrize("name", [sweep.WIRE_BASELINE_SCENARIO,
                                  sweep.WIRE_SIGN_SCENARIO,
                                  sweep.WIRE_INT8_SCENARIO])
def test_wire_cell_against_the_reference(name):
    ps = sweep.get_pod_scenario(name)
    ref = jsweep.get_pod_scenario(name)
    out = sweep.run_microcell(ps, None, D_SMALL, SEED,
                              device="cpu")
    inputs, jkey = _ref_inputs(ps)
    stacked = inputs["report"]
    want = jaggregate_reported(stacked, ref.robust_config(), key=jkey)
    assert not _close(out["aggregate"], want)
    if ps.compression == "int8_stochastic":
        payload = jcompression.get_codec(ps.compression).encode(
            stacked, key=jax.random.fold_in(jkey, 29))
        assert np.array_equal(out["payload"]["q"].numpy(),
                              np.asarray(payload["q"]))
        assert np.array_equal(out["payload"]["scale"].numpy(),
                              np.asarray(payload["scale"]))
    key = prng.PRNGKey(SEED)
    assert np.array_equal(key.numpy(), np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("name", list(sweep.STALE_SCENARIOS))
def test_stale_cell_against_the_reference(name):
    ps = sweep.get_pod_scenario(name)
    ref = jsweep.get_pod_scenario(name)
    out = sweep.run_microcell(ps, None, D_SMALL, SEED,
                              device="cpu")
    inputs, jkey = _ref_inputs(ps)
    rc = ref.robust_config()
    arrival = jstaleness.make_arrival(
        ref.arrival, num_workers=ref.num_groups,
        staleness_bound=ref.staleness_bound)
    buf = jstaleness.StalenessBuffer(
        grads=inputs["buffer"], age=inputs["age"],
        bound=jnp.asarray(ref.staleness_bound, jnp.int32))
    fresh = arrival.arrive(jkey, 0, jnp.zeros((ref.num_groups,), bool))
    merged, buf = jstaleness.merge_reports(buf, inputs["report"], fresh)
    want = jaggregate_reported(
        merged, rc, key=jkey,
        staleness=(buf.age, buf.bound, rc.staleness_discount))
    assert not _close(out["aggregate"], want)
    assert np.array_equal(out["buffer"].numpy(), np.asarray(buf.grads))
    assert np.array_equal(out["age"].numpy(), np.asarray(buf.age))


# ---------------------------------------------------------------------------
# the checked-in record

def test_checked_in_record_covers_registry_and_passes_the_gates():
    assert os.path.exists(sweep.RECORD_PATH), \
        "src/repro_torch/sim/pod_sweeps.json missing — run " \
        "`python -m repro_torch.sim.sweep --all` and commit it"
    rec = sweep.load_record()
    scenarios = rec["scenarios"]
    assert list(scenarios) == sweep.available()
    assert {e["mesh"] for e in scenarios.values()} == set(sweep.POD_MESHES)
    for name, entry in scenarios.items():
        ps = sweep.get_pod_scenario(name)
        assert entry["collective_bytes_per_device"] > 0, name
        assert entry["step"] == ("report_wire" if ps.wire else
                                 "stale_report" if ps.stale
                                 else "train_step"), name
        assert entry["rank"] == 0 and entry["arch"] == ps.arch, name
    assert sweep.compare_payloads(rec, rec) == ([], [])
    assert sweep.shard_scaling_problems(scenarios) == []
    assert sweep.compression_wire_problems(scenarios) == []
    assert sweep.main(["--check", "--fresh-from", sweep.RECORD_PATH]) == 0
