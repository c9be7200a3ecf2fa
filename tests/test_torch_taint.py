"""repro_torch.verify Layer C: the influence engine's unit cases on aten
graphs, the per-aggregator certificate table (the soundness split
rediscovered from dataflow), parity with the JAX package's certificates,
the shard-local certificates, precision fixtures (tainted reads inside
bounded ops must NOT fire), the leaky and undeclared dummies, the
production route's round-kernel op, the multi-round trace, the SARIF CLI
surface and the ignore audit.

Two subprocesses run beside the in-process tests, started by the module
fixture: the JAX package's own certificates and findings (under the
reference's original threefry setting), and the port's shard-local
certificates (rank 0 of an abstract mesh of 4 ranks)."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core import aggregators
from repro_torch.verify import contracts, influence, taint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAINT_FIXTURES = os.path.join(REPO, "tests", "fixtures", "verify_torch",
                              "taint")
REF_TAINT_FIXTURES = os.path.join(REPO, "tests", "fixtures", "verify",
                                  "taint")
NAMES = [n for n in aggregators.available() if not n.startswith("_")]

RAW_REPORT = influence.raw("report")
CLEAN = influence.CLEAN_LABEL


def labels_of(fn, in_labels, *example_args, fired=None):
    gm = contracts.trace(fn, example_args)
    return influence.run_graph(gm, in_labels, fired=fired)


def _as_json(rep):
    return {path: [lab.level, sorted(lab.kinds), sorted(lab.sources)]
            for path, lab in rep.leaves}


REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_threefry_partitionable", False)
    sys.path.insert(0, {fixtures!r})
    from repro.core import aggregators
    from repro.verify import contracts, taint

    def cert(rep):
        return {{p: [l.level, sorted(l.kinds), sorted(l.sources)]
                 for p, l in rep.leaves}}

    names = [n for n in aggregators.available() if not n.startswith("_")]
    out = {{"certs": {{}}, "rules": {{}}}}
    for name in names:
        out["certs"][name] = cert(taint.classify_aggregator(name))
        out["rules"][name] = sorted(
            f.rule for f in taint.check_aggregator_taint(name))
    import leaky_scale
    try:
        out["leaky"] = sorted({{f.rule for f in
                               taint.check_aggregator_taint(
                                   leaky_scale.NAME)}})
    finally:
        leaky_scale.unregister()
        contracts.clear_trace_cache()
    import clean_clip
    try:
        out["clean_clip"] = sorted(
            f.rule for f in taint.check_aggregator_taint(clean_clip.NAME))
    finally:
        clean_clip.unregister()
        contracts.clear_trace_cache()

    @aggregators.register("_test_undeclared_median", "test-only")
    def _undeclared(stacked, **_kw):
        return aggregators.coordinate_median_aggregator(stacked)
    out["undeclared"] = sorted(
        f.rule for f in taint.check_aggregator_taint(
            "_test_undeclared_median"))
    out["round"] = sorted(f.rule for f in taint.check_round_taint())
    print(json.dumps(out))
""").format(fixtures=REF_TAINT_FIXTURES)

SHARD_LOCAL_SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {fixtures!r})
    from repro_torch.core import aggregators
    from repro_torch.verify import contracts, taint

    out = {{"certs": {{}}, "rules": {{}}}}
    for name in [n for n in aggregators.available()
                 if not n.startswith("_")]:
        rep = taint.classify_aggregator(name, mode="shard_local")
        out["certs"][name] = {{p: [l.level, sorted(l.kinds),
                                  sorted(l.sources)]
                              for p, l in rep.leaves}}
        out["rules"][name] = sorted(f.rule for f in
                                    taint.check_aggregator_taint(
                                        name, mode="shard_local"))
    import leaky_scale
    try:
        fs = taint.check_aggregator_taint(leaky_scale.NAME,
                                          mode="shard_local")
        out["leaky"] = [[f.rule, f.message] for f in fs]
    finally:
        leaky_scale.unregister()
        contracts.clear_trace_cache()
    print(json.dumps(out))
""").format(fixtures=TAINT_FIXTURES)


@pytest.fixture(scope="module")
def beside():
    """The two subprocesses' results: {"reference": ..., "shard_local":
    ...}, started at once and read when a test first needs them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for key, script in (("reference", REFERENCE_SCRIPT),
                            ("shard_local", SHARD_LOCAL_SCRIPT))}
    procs["cli_c"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.verify", "--layer", "c",
         "--strict", "--aggregators", "coord_median", "mean"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    results = {}

    def get(key):
        if key not in results:
            out, err = procs[key].communicate(timeout=600)
            if key == "cli_c":
                results[key] = (procs[key].returncode, out, err)
            else:
                assert procs[key].returncode == 0, err[-4000:]
                results[key] = json.loads(out.strip().splitlines()[-1])
        return results[key]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# --------------------------------------------------------------------------
# the influence engine: per-op transfer rules

def test_median_demotes_to_order_stat(beside):
    (out,) = labels_of(lambda g: torch.median(g), [RAW_REPORT],
                       torch.zeros(8))
    assert out.level == influence.BOUNDED
    assert "order_stat" in out.kinds and out.sources == {"report"}


def test_sort_demotes_to_order_stat():
    (out,) = labels_of(lambda g: torch.sort(g, dim=0).values[3],
                       [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.BOUNDED and "order_stat" in out.kinds


def test_mul_by_mask_does_not_launder():
    """The norm_select unsoundness: masking a raw report by a 0/1 mask
    (even one derived through an order statistic) rescales it: RAW."""
    def f(g):
        norms = torch.sqrt(torch.sum(torch.square(g), dim=1))
        keep = (norms <= torch.median(norms)).to(g.dtype)
        return torch.sum(g * keep[:, None], dim=0) / torch.sum(keep)

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.RAW


def test_sum_and_mean_stay_raw():
    (out,) = labels_of(lambda g: torch.mean(g, dim=0), [RAW_REPORT],
                       torch.zeros(8, 4))
    assert out.level == influence.RAW and out.kinds == frozenset()


def test_amax_scale_stays_raw():
    """An int8-codec amax scale derived from the report is RAW: the
    dequantize-by-tainted-scale bug class."""
    (out,) = labels_of(lambda g: torch.amax(torch.abs(g)) * torch.ones(4),
                       [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.RAW


def test_gather_with_tainted_index_is_rank_select():
    def f(g):
        norms = torch.sum(torch.square(g), dim=1)
        return torch.index_select(g, 0, torch.argmin(norms).reshape(1))[0]

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.BOUNDED and "rank_select" in out.kinds


def test_gather_with_clean_index_passes_label_through():
    (out,) = labels_of(lambda g: g[0], [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.RAW


def test_where_over_clean_constants_is_sign_vote():
    def f(g):
        votes = torch.sum(torch.sign(g).to(torch.float32), dim=0)
        return torch.where(votes >= 0, 1.0, -1.0)

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.BOUNDED and "sign_vote" in out.kinds


def test_where_with_tainted_branch_joins():
    def f(g):
        s = torch.sum(g, dim=0)
        return torch.where(s >= 0, s, -1.0)

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.RAW


def test_clamp_against_clean_bounds_demotes_to_clip():
    (out,) = labels_of(lambda g: torch.clamp(torch.sum(g, dim=0), -1.0, 1.0),
                       [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.BOUNDED and "clip" in out.kinds


def test_one_sided_clamp_bounds_nothing():
    """jnp.clip lowers to max then min, which the reference joins: a
    one-sided clamp (or minimum/maximum) bounds nothing."""
    for fn in (lambda g: torch.clamp(torch.sum(g, dim=0), min=-1.0),
               lambda g: torch.sum(g, dim=0).clamp_min(-1.0).clamp_max(1.0),
               lambda g: torch.maximum(torch.sum(g, dim=0),
                                       torch.zeros(4))):
        (out,) = labels_of(fn, [RAW_REPORT], torch.zeros(8, 4))
        assert out.level == influence.RAW and not out.kinds


def test_bool_outputs_cap_and_chains_stay_bounded():
    def f(g):
        return torch.sum(((g > 0.0) & (g < 1.0)).to(torch.int32))

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8))
    assert out.level == influence.BOUNDED
    assert out.kinds == frozenset()   # a bool is not a sanitizer


def test_shape_only_ops_are_clean():
    (out,) = labels_of(lambda g: torch.ones_like(g) + g.new_zeros(8),
                       [RAW_REPORT], torch.zeros(8))
    assert out.level == influence.CLEAN


def test_unrolled_loop_carries_taint():
    def f(g):
        acc = torch.zeros(4)
        for _ in range(10):
            acc = acc + g
        return acc

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(4))
    assert out.level == influence.RAW


def test_arity_mismatch_raises():
    gm = contracts.trace(lambda a, b: a + b, (torch.ones(1), torch.ones(1)))
    with pytest.raises(ValueError, match="arity"):
        influence.run_graph(gm, [CLEAN])


def _weiszfeld(points, passes, c=None):
    y = torch.mean(points, dim=0) if c is None else c
    for _ in range(passes):
        d = torch.sqrt(torch.sum((points - y) ** 2, dim=1) + 1e-24)
        inv = 1.0 / d
        y = (inv / torch.sum(inv)) @ points
    return y


def test_unrolled_weiszfeld_is_credited():
    fired = []
    (out,) = labels_of(lambda z: _weiszfeld(z, 3), [RAW_REPORT],
                       torch.zeros(5, 4), fired=fired)
    assert out.level == influence.BOUNDED and out.kinds == {"weiszfeld"}
    assert len(fired) == 2          # every pass that reads an iterate


def test_one_reweighting_pass_around_a_clean_center_is_not_weiszfeld():
    (out,) = labels_of(lambda z, c: _weiszfeld(z, 1, c), [RAW_REPORT, CLEAN],
                       torch.zeros(5, 4), torch.zeros(4))
    assert out.level == influence.RAW and out.kinds == frozenset()


def test_iterate_does_not_credit_other_points():
    """An iterate of z, used to reweight other raw values w, is no
    Weiszfeld step of w."""
    def f(z, w):
        y = _weiszfeld(z, 1)
        d = torch.sqrt(torch.sum((z - y) ** 2, dim=1) + 1e-24)
        return ((1.0 / d) / torch.sum(1.0 / d)) @ w

    (out,) = labels_of(f, [RAW_REPORT, RAW_REPORT], torch.zeros(5, 4),
                       torch.zeros(5, 4))
    assert out.level == influence.RAW


def test_abstract_mesh_gather_keeps_its_operand():
    """A collective on the abstract mesh is a graph node with the local
    partial as its operand: gathered raw partials stay RAW."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import meshctx
    mesh = mesh_lib.make_mesh((4,), ("model",), rank=0)

    def f(g):
        with meshctx.set_mesh(mesh):
            return meshctx.parts(torch.sum(g * g, dim=1), "model").sum(0)

    (out,) = labels_of(f, [RAW_REPORT], torch.zeros(8, 4))
    assert out.level == influence.RAW


# --------------------------------------------------------------------------
# the certificate table: the soundness split from dataflow alone

EXPECTED = {
    # ROBUST family: BOUNDED with the declared sanitizer on the dataflow
    "coord_median": (influence.BOUNDED, {"order_stat"}),
    "coord_trimmed_mean": (influence.BOUNDED, {"order_stat"}),
    "coordinate_median": (influence.BOUNDED, {"order_stat"}),
    "trimmed_mean": (influence.BOUNDED, {"order_stat"}),
    "geomed": (influence.BOUNDED, {"weiszfeld"}),
    "gmom_per_leaf": (influence.BOUNDED, {"weiszfeld"}),
    "gmom": (influence.BOUNDED, {"order_stat", "weiszfeld"}),
    "int8_gmom": (influence.BOUNDED, {"order_stat", "weiszfeld"}),
    "norm_filter_gmom": (influence.BOUNDED, {"order_stat", "weiszfeld"}),
    "krum": (influence.BOUNDED, {"order_stat", "rank_select"}),
    "sign_sgd_majority": (influence.BOUNDED, {"sign_vote"}),
    # KNOWN-UNSOUND family: RAW whatever robust ops appear upstream
    "mean": (influence.RAW, set()),
    "random_select": (influence.RAW, set()),
    "norm_select": (influence.RAW, {"order_stat"}),
    "norm_clip_mean": (influence.RAW, {"order_stat"}),
}

KNOWN_UNSOUND = {"mean", "norm_select", "norm_clip_mean"}


def test_table_covers_the_registry():
    assert set(NAMES) == set(EXPECTED), "table drifted from the registry"


@pytest.mark.parametrize("name", NAMES)
def test_certificate_unsharded(name):
    rep = taint.classify_aggregator(name)
    assert (rep.level, set(rep.kinds)) == EXPECTED[name], \
        (name, rep.level, sorted(rep.kinds))
    declared = aggregators.get_aggregator(name).sanitization_point
    if name in KNOWN_UNSOUND:
        assert not rep.bounded and declared is None
    if declared is not None:
        assert rep.bounded and declared in rep.kinds
    assert taint.check_aggregator_taint(name) == []


@pytest.mark.parametrize("name", NAMES)
def test_certificate_equals_reference(name, beside):
    """Leaf for leaf, in level, kinds and sources, the JAX package's
    classify_aggregator(name, mode="unsharded"); and the same Layer C
    rules fire (none)."""
    ref = beside("reference")
    assert _as_json(taint.classify_aggregator(name)) == ref["certs"][name]
    assert sorted(f.rule for f in taint.check_aggregator_taint(name)) == \
        ref["rules"][name]


# --------------------------------------------------------------------------
# fixture corpus: the leaky dummy fires, the precision dummy does not

def _load_fixture(modname):
    import importlib
    if TAINT_FIXTURES not in sys.path:
        sys.path.insert(0, TAINT_FIXTURES)
    return importlib.import_module(modname)


def test_leaky_dummy_rejected_rv301_unsharded(beside):
    mod = _load_fixture("leaky_scale")
    try:
        fs = taint.check_aggregator_taint(mod.NAME)
        assert fs and all(f.rule == "RV301" for f in fs), \
            [f.format() for f in fs]
        assert any("sanitization_point='weiszfeld'" in f.message
                   for f in fs)
        assert all(f.path == f"<aggregator:{mod.NAME}>" for f in fs)
        assert sorted({f.rule for f in fs}) == beside("reference")["leaky"]
    finally:
        mod.unregister()
        contracts.clear_trace_cache()


def test_clean_clip_zero_false_positives(beside):
    """Precision: a dummy that READS tainted values everywhere (median
    norm envelope, coordinate-median base) but only inside bounded ops
    gives zero RV301/RV303."""
    mod = _load_fixture("clean_clip")
    try:
        rep = taint.classify_aggregator(mod.NAME)
        assert rep.bounded and "order_stat" in rep.kinds
        assert taint.check_aggregator_taint(mod.NAME) == []
        assert beside("reference")["clean_clip"] == []
    finally:
        mod.unregister()
        contracts.clear_trace_cache()


def test_norm_filter_gmom_precision():
    rep = taint.classify_aggregator("norm_filter_gmom")
    assert rep.bounded
    assert taint.check_aggregator_taint("norm_filter_gmom") == []


def test_undeclared_but_bounded_dummy_fires_rv303(beside):
    @aggregators.register("_test_undeclared_median",
                          "test-only: coordinate median with no declared "
                          "sanitization_point")
    def _undeclared(stacked, **_kw):
        return aggregators.coordinate_median_aggregator(stacked)

    try:
        fs = taint.check_aggregator_taint("_test_undeclared_median")
        assert [f.rule for f in fs] == ["RV303"], [f.format() for f in fs]
        assert "stale" in fs[0].message
        assert [f.rule for f in fs] == beside("reference")["undeclared"]
    finally:
        aggregators._REGISTRY.pop("_test_undeclared_median", None)
        contracts.clear_trace_cache()


# --------------------------------------------------------------------------
# the production route: the round kernel's op where the passes were

def test_production_route_op_stands_for_the_weiszfeld_passes():
    r = taint.production_route("gmom")
    every = set(range(r["outputs"]))
    assert len(r["ops"]) == 1
    assert r["op_reaches"] == every == r["weiszfeld_reaches"]
    assert r["production_fires"] == 0
    assert taint.check_production_route("gmom") == []


def test_production_route_is_opaque_to_the_engine():
    """No sanitizer is credited to the op by name: the production trace
    certifies RAW, which is why the certificate is computed on the plain
    route."""
    gm, out, args = contracts.traced_flat("gmom", seed=0, route="cuda")
    rep = taint._certify(gm, out, args, "gmom", "none", "production")
    assert rep.level == influence.RAW


# --------------------------------------------------------------------------
# the multi-round trace

def test_round_trace_green(beside):
    assert taint.check_round_taint() == []
    assert beside("reference")["round"] == []


def test_round_trace_section_labels():
    rows = taint.classify_round()
    by_section = {}
    for section, _path, label in rows:
        by_section.setdefault(section, []).append(label)
    # reports reach params only through the bounded aggregator channel
    assert all(l.level == influence.BOUNDED for l in by_section["params"])
    assert all(l.level < influence.RAW for l in by_section["opt_state"])
    assert all(l.level < influence.RAW for l in by_section["metrics"])
    # ages couple rounds through timing only, never report values
    for l in by_section["stale_buffer.age"]:
        assert "report" not in l.sources
    # the buffered last reports are adversary memory: necessarily RAW
    assert any(l.level == influence.RAW
               for l in by_section["stale_buffer.grads"])
    assert {p for s, p, _ in rows if s == "metrics"} >= {
        "['loss_mean']", "['agg_grad_norm']", "['byz_count']",
        "['stale_count']"}


def test_round_red_paths_fire(monkeypatch):
    """RV301/RV302 finding logic over fabricated round labels: a RAW
    params leaf, a RAW metrics leaf, and a report-steered age."""
    rows = [
        ("params", "['w']", influence.raw("report")),
        ("metrics", "['agg_grad_norm']", influence.raw("report")),
        ("stale_buffer.age", "", influence.Label(
            level=influence.BOUNDED, kinds=frozenset({"order_stat"}),
            sources=frozenset({"report"}))),
        ("attack_state", "['ema_norm']", influence.raw("attack_state")),
    ]
    monkeypatch.setattr(taint, "classify_round", lambda **_kw: rows)
    fs = taint.check_round_taint()
    assert sorted(f.rule for f in fs) == ["RV301", "RV302", "RV302"]
    assert any("params['w']" in f.message for f in fs)
    assert any("report VALUES" in f.message for f in fs)
    assert all(f.path == taint.ROUND_ANCHOR for f in fs)


def test_round_red_path_from_a_leak_in_the_trace(monkeypatch):
    """A real leak in the traced round: the optimizer adds the buffered
    reports' amax to the update, and RV301 fires on params."""
    from repro_torch.optim import optimizers
    real_sgd = optimizers.sgd

    def leaky_sgd(lr, **kw):
        opt = real_sgd(lr, **kw)
        holder = {}

        def update(grads, state, params=None):
            u, s = opt.update(grads, state, params)
            leak = holder.get("leak", 0.0)
            return {k: v + leak for k, v in u.items()}, s

        return dataclasses.replace(opt, update=update), holder

    made = {}

    def sgd(lr, **kw):
        opt, holder = leaky_sgd(lr, **kw)
        made["holder"] = holder
        return opt

    monkeypatch.setattr(optimizers, "sgd", sgd)
    from repro_torch.core import staleness
    real_merge = staleness.merge_reports

    def merge(buf, reported, fresh):
        merged, nbuf = real_merge(buf, reported, fresh)
        made["holder"]["leak"] = 1e-6 * torch.amax(torch.abs(buf.grads["w"]))
        return merged, nbuf

    monkeypatch.setattr(staleness, "merge_reports", merge)
    contracts.clear_trace_cache()
    try:
        fs = taint.check_round_taint()
    finally:
        contracts.clear_trace_cache()
    assert any(f.rule == "RV301" and f.message.startswith("params")
               for f in fs), [f.format() for f in fs]


# --------------------------------------------------------------------------
# CLI: SARIF serialization + the ignore audit + the taint layer alone

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))


def fx(name):
    return os.path.join(REPO, "tests", "fixtures", "verify_torch", name)


def test_cli_sarif_stdout_is_machine_parseable():
    res = _run_cli("--layer", "a", "--strict", "--format", "sarif",
                   "--paths", fx("rv102_bad.py"))
    assert res.returncode == 1, (res.stdout, res.stderr)
    doc = json.loads(res.stdout)       # progress went to stderr
    assert doc["version"] == "2.1.0"
    results = doc["runs"][0]["results"]
    assert {r["ruleId"] for r in results} == {"RV102"}
    loc = results[0]["locations"][0]["physicalLocation"]
    assert loc["region"]["startLine"] >= 1
    rules = doc["runs"][0]["tool"]["driver"]["rules"]
    assert [r["id"] for r in rules] == ["RV102"]
    assert doc["runs"][0]["tool"]["driver"]["name"] == "repro_torch.verify"
    assert "[verify]" in res.stderr and "[verify]" not in res.stdout


def test_cli_sarif_output_file_written_even_under_strict(tmp_path):
    out = tmp_path / "verify.sarif"
    res = _run_cli("--layer", "a", "--strict", "--format", "sarif",
                   "--output", str(out), "--paths", fx("rv102_bad.py"))
    assert res.returncode == 1
    doc = json.loads(out.read_text())
    assert doc["runs"][0]["results"]


def test_sarif_anchor_maps_to_the_port_registry():
    from repro_torch.verify import sarif
    from repro_torch.verify.rules import Finding
    doc = sarif.to_sarif([Finding("RV301", "<aggregator:x>", 0, 0, "m")])
    res = doc["runs"][0]["results"][0]
    assert res["locations"][0]["physicalLocation"]["artifactLocation"][
        "uri"] == "src/repro_torch/core/aggregators.py"
    assert "[<aggregator:x>]" in res["message"]["text"]


def test_cli_audit_ignores_clean_tree():
    res = _run_cli("--audit-ignores")
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "0 stale" in res.stdout
    # the port's real escape hatches are listed with their reasons
    assert "kernels/geomed/round.py" in res.stdout
    assert "r and x are float32" in res.stdout


def test_cli_audit_ignores_fails_on_stale_rule_id():
    res = _run_cli("--audit-ignores", "--paths", fx("ignore_unknown.py"))
    assert res.returncode == 1, (res.stdout, res.stderr)
    assert "STALE" in res.stdout


def test_cli_taint_layer_only(beside):
    returncode, out, err = beside("cli_c")
    assert returncode == 0, (out, err)
    assert "layer C" in out and "round trace" in out


# --------------------------------------------------------------------------
# the shard-local certificates (read last: their subprocess runs beside
# the tests above)

@pytest.mark.parametrize("name", NAMES)
def test_shard_local_certificate_equals_unsharded(name, beside):
    got = beside("shard_local")
    assert got["certs"][name] == _as_json(taint.classify_aggregator(name))
    assert got["rules"][name] == []


def test_leaky_dummy_rejected_rv301_shard_local(beside):
    got = beside("shard_local")["leaky"]
    assert got and all(r == "RV301" for r, _ in got)
    assert all("shard_local" in m for _, m in got)
