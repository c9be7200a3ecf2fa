"""repro_torch.verify: the port's Layer A fixture corpus (exact rule IDs
and spans, the same as the reference's corpus gives the reference's
lint), the escape-hatch policy, the CLI's exit-code contract, RV204's
launch-budget drift gate, and Layer B's shard-contract analyzer (every
registered rule on abstract meshes of 2 and 4 ranks, planted
misdeclarations, and the traced collective log against one spawn of real
gloo ranks)."""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import aggregators
from repro_torch.core import shard_aggregation as sa
from repro_torch.models import meshctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "verify_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "verify")
NAMES = [n for n in aggregators.available() if not n.startswith("_")]


def fx(name):
    return os.path.join(FIXTURES, name)


def lint(name):
    from repro_torch.verify import lint_file
    return lint_file(fx(name))


def ids_lines(findings):
    return [(f.rule, f.line) for f in findings]


# --------------------------------------------------------------------------
# Layer A: one bad + one clean fixture per rule, exact IDs and lines

def test_rv101_bad_exact_span():
    fs = lint("rv101_bad.py")
    assert ids_lines(fs) == [("RV101", 10)]
    f = fs[0]
    assert f.col == 11 and f.end_line == 10        # the call expression
    assert "dim=0" in f.message and "chain" in f.message


def test_rv101_good_clean():
    assert lint("rv101_good.py") == []


def test_rv102_bad_both_seed_forms():
    fs = lint("rv102_bad.py")
    assert ids_lines(fs) == [("RV102", 4), ("RV102", 8)]
    assert "prng.PRNGKey(0)" in fs[0].message
    assert "manual_seed(42)" in fs[1].message


def test_rv102_good_entry_points_exempt():
    assert lint("rv102_good.py") == []


def test_rv103_bad_import_time_mutations():
    fs = lint("rv103_bad.py")
    assert [f.rule for f in fs] == ["RV103"] * 3
    assert [f.line for f in fs] == [4, 7, 11]      # top-level / if / class


def test_rv103_good_runtime_only():
    assert lint("rv103_good.py") == []


def test_rv104_bad_missing_and_invalid_metadata():
    fs = lint("rv104_bad.py")
    assert [f.rule for f in fs] == ["RV104"] * 3
    assert [f.line for f in fs] == [5, 5, 10]
    assert "description" in fs[0].message
    assert "shard_contract" in fs[1].message
    assert "literal" in fs[2].message


def test_rv104_good_clean():
    assert lint("rv104_good.py") == []


def test_rv105_bad_mean_and_matmul():
    fs = lint("rv105_bad.py")
    assert ids_lines(fs) == [("RV105", 7), ("RV105", 11)]
    assert "dim=0" in fs[0].message
    assert "torch.matmul" in fs[1].message and "float32" in fs[1].message


def test_rv105_good_clean():
    assert lint("rv105_good.py") == []


def test_rv105_bad_vote_accumulation():
    """Majority-vote counting is a robust-stat reduction too, in the
    function and the method form."""
    fs = lint("rv105_bad_vote.py")
    assert ids_lines(fs) == [("RV105", 7), ("RV105", 11)]
    assert all("dim=0" in f.message for f in fs)


def test_rv105_good_vote_clean():
    assert lint("rv105_good_vote.py") == []


def test_rv106_bad_carry_outside_train_state():
    fs = lint("rv106_bad.py")
    assert ids_lines(fs) == [("RV106", 8), ("RV106", 8)]
    msgs = " | ".join(f.message for f in fs)
    assert "staleness_buffer" in msgs and "not a plain name" in msgs


def test_rv106_good_clean():
    assert lint("rv106_good.py") == []


def test_rv106_reads_make_run_rounds():
    """The port's own round loop carries params, opt_state, astate, buf
    and the metrics rows: all TrainState fields, so it is clean, and a
    TrainState without stale_buffer would flag ``buf``."""
    from repro_torch.verify.ast_rules import rv106
    from repro_torch.verify.rules import SourceContext
    path = os.path.join(REPO, "src", "repro_torch", "core",
                        "robust_train.py")
    with open(path) as f:
        ctx = SourceContext(path, f.read())
    assert ctx.train_scan
    assert rv106(ctx) == []
    fs = rv106(ctx, fields=("params", "opt_state", "attack_state",
                            "history"))
    assert [f.message.split("'")[1] for f in fs] == ["buf"]


def test_rv107_bad_float_ages():
    fs = lint("rv107_bad.py")
    assert [f.rule for f in fs] == ["RV107"] * 2
    assert [f.line for f in fs] == [17, 21]
    assert all("integer" in f.message for f in fs)


def test_rv107_good_clean():
    assert lint("rv107_good.py") == []


def test_rv107_flags_buffer_not_train_state_resident():
    from repro_torch.verify.ast_rules import rv107
    from repro_torch.verify.rules import SourceContext
    with open(fx("rv107_good.py")) as f:
        ctx = SourceContext(fx("rv107_good.py"), f.read())
    fs = rv107(ctx, fields=("params", "opt_state", "attack_state"))
    assert any("stale_buffer" in f.message and f.rule == "RV107"
               for f in fs)
    assert rv107(ctx) == []


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(FIXTURES) if f.endswith(".py")))
def test_fixture_corpus_parity_with_reference(name):
    """Each fixture's torch twin fires the rules, on the lines, that the
    reference's fixture fires in the reference's lint."""
    from repro.verify import lint_file as ref_lint
    ref = ids_lines(ref_lint(os.path.join(REF_FIXTURES, name)))
    assert ids_lines(lint(name)) == ref


@pytest.mark.parametrize("rel", [
    "core/aggregators.py", "core/geometric_median.py",
    "core/shard_aggregation.py", "core/robust_train.py",
    "kernels/geomed/round.py", "core/staleness.py"])
def test_marked_modules_lint_like_their_reference(rel):
    """The registry and the marked modules: the port's lint of the port's
    module fires the rules the reference's lint fires on the reference's
    (none), and the port's markers scope it as the reference's do."""
    from repro.verify import lint_file as ref_lint
    from repro.verify.rules import SourceContext as RefContext
    from repro_torch.verify import lint_file
    from repro_torch.verify.rules import SourceContext
    ref_path = os.path.join(REPO, "src", "repro", rel)
    path = os.path.join(REPO, "src", "repro_torch", rel)
    assert sorted({f.rule for f in lint_file(path)}) == \
        sorted({f.rule for f in ref_lint(ref_path)})
    with open(ref_path) as f:
        ref = RefContext(ref_path, f.read())
    with open(path) as f:
        port = SourceContext(path, f.read())
    assert (port.bit_stable, port.robust_stat, port.train_scan) == \
        (ref.bit_stable, ref.robust_stat, ref.train_scan)


# --------------------------------------------------------------------------
# escape hatch: suppression drops the finding, but only WITH justification

def test_ignore_justified_is_silent():
    assert lint("ignore_justified.py") == []


def test_ignore_without_justification_raises_rv100():
    fs = lint("ignore_unjustified.py")
    assert ids_lines(fs) == [("RV100", 5)]
    assert "justification" in fs[0].message


def test_ignore_unknown_rule_id_raises_rv100_and_keeps_finding():
    fs = lint("ignore_unknown.py")
    assert sorted(f.rule for f in fs) == ["RV100", "RV102"]


def test_spellings_do_not_cross():
    """The port's ignores and markers are invisible to the reference's
    SourceContext and the reference's to the port's."""
    from repro.verify.rules import SourceContext as RefContext
    from repro_torch.verify.rules import SourceContext
    src = ("# repro_torch: bit-stable\n"
           "x = 1  # repro_torch: ignore[RV102] why\n"
           "# repro: train-scan\n"
           "y = 2  # repro: ignore[RV102] why\n")
    port, ref = SourceContext("p.py", src), RefContext("r.py", src)
    assert port.bit_stable and not port.train_scan
    assert [s.line for s in port.suppressions] == [2]
    assert ref.train_scan and not ref.bit_stable
    assert [s.line for s in ref.suppressions] == [4]


def test_every_rule_documented_in_catalog():
    from repro.verify.rules import RULES as REF_RULES
    from repro_torch.verify.rules import RULES
    assert list(RULES) == list(REF_RULES)
    for rid, rule in RULES.items():
        assert rule.motivation and rule.layer == REF_RULES[rid].layer


def test_train_state_fields_parse():
    from repro_torch.verify.ast_rules import train_state_fields
    from repro_torch.core.train_state import TrainState
    assert train_state_fields() == TrainState._fields


# --------------------------------------------------------------------------
# CLI exit codes

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))


def test_cli_strict_fails_on_bad_fixture():
    res = _run_cli("--layer", "a", "--strict", "--paths",
                   fx("rv102_bad.py"))
    assert res.returncode == 1, (res.stdout, res.stderr)
    assert "RV102" in res.stdout


def test_cli_nonstrict_reports_but_passes():
    res = _run_cli("--layer", "a", "--paths", fx("rv102_bad.py"))
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "RV102" in res.stdout


def test_cli_strict_clean_on_good_fixture():
    res = _run_cli("--layer", "a", "--strict", "--paths",
                   fx("rv102_good.py"))
    assert res.returncode == 0, (res.stdout, res.stderr)


def test_cli_strict_clean_on_src_tree():
    """Zero Layer-A findings on the port's tree (its default root)."""
    res = _run_cli("--layer", "a", "--strict")
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert os.path.join("src", "repro_torch") in res.stdout


def test_cli_internal_error_exit_2(tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    res = _run_cli("--layer", "a", "--paths", str(broken))
    assert res.returncode == 2, (res.stdout, res.stderr)
    assert "INTERNAL ERROR" in res.stderr


def test_cli_list_rules():
    res = _run_cli("--list-rules")
    assert res.returncode == 0
    for rid in ("RV101", "RV204", "RV303"):
        assert rid in res.stdout


# --------------------------------------------------------------------------
# RV204: the round kernel's launch budget (in process, no card)

def test_smem_audit_clean():
    from repro_torch.verify.smem import check_smem_budget
    assert check_smem_budget() == []


def test_smem_audit_reads_the_sources():
    from repro_torch.kernels.geomed import round as round_mod
    from repro_torch.verify.smem import source_constants
    c = source_constants()
    assert c["kMaxBatches"] == round_mod.MAX_BATCHES
    assert c["kOnepassStages"] == 3
    assert c["kOnepassMaxD"] == round_mod.D_ONEPASS


def test_smem_audit_catches_budget_over_card(monkeypatch):
    from repro_torch.verify import smem
    monkeypatch.setattr(smem, "SMEM_OPTIN_BYTES", 32 * 1024)
    fs = smem.check_smem_budget()
    assert any(f.rule == "RV204" and "shared memory" in f.message
               for f in fs)


def test_smem_audit_catches_max_batches_drift(monkeypatch):
    from repro_torch.kernels.geomed import round as round_mod
    from repro_torch.verify.smem import check_smem_budget
    monkeypatch.setattr(round_mod, "MAX_BATCHES", 65)
    fs = check_smem_budget()
    assert any(f.rule == "RV204" and "drifted" in f.message
               and "k=65" in f.message for f in fs)


def test_smem_audit_catches_stage_formula_drift(monkeypatch):
    from repro_torch.kernels.geomed import round as round_mod
    from repro_torch.verify.smem import check_smem_budget
    monkeypatch.setattr(round_mod, "ONEPASS_STAGE_BYTES", 32768)
    fs = check_smem_budget()
    assert any(f.rule == "RV204" and "onepass_rows_per_stage" in f.message
               for f in fs)


def test_smem_audit_catches_dispatcher_over_promise(monkeypatch):
    from repro_torch.kernels.geomed import round as round_mod
    from repro_torch.verify.smem import check_smem_budget
    monkeypatch.setattr(round_mod, "linreg_route", lambda d: "one_pass")
    fs = check_smem_budget()
    assert any(f.rule == "RV204" and "linreg_route" in f.message
               for f in fs)


# --------------------------------------------------------------------------
# Layer B: the shard-contract analyzer on abstract meshes

@pytest.fixture(scope="module")
def real_logs():
    """ONE spawn of 4 gloo ranks: every registered rule's real collective
    log on its rank of a real ("model",) mesh."""
    from repro_torch.verify import contracts
    return contracts.real_collectives(NAMES, num_shards=4)


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_layer_b_every_rule_clean(name, num_shards):
    from repro_torch.verify import contracts
    fs = contracts.check_aggregator(name, num_shards=num_shards)
    assert fs == [], [f.format() for f in fs]
    calls = contracts.shard_map_log(name, num_shards=num_shards, scale=1,
                                    seed=0)
    contract = aggregators.get_aggregator(name).shard_contract
    assert (calls == []) == (contract == "coordinate_wise"), (name, calls)


def test_traced_graph_holds_the_logged_collectives():
    """The traced graph's transport nodes are the log's calls, each with
    the rank's local bytes as its operand (Layer C reads that edge)."""
    from repro_torch.verify import collectives, contracts
    gm, _out, log, _args = contracts.traced_shard_map(
        "gmom", num_shards=4, scale=1, seed=0)
    assert log and collectives.graph_transfers(gm) == len(log)
    ops = [n for n in gm.graph.nodes if n.op == "call_function"
           and "mesh_transfer" in str(n.target)]
    assert len(ops) == len(log)
    assert all(hasattr(n.args[0], "op") for n in ops)


def test_traced_log_equals_real_gloo_ranks(real_logs):
    from repro_torch.verify import collectives, contracts
    for name in NAMES:
        traced = contracts.shard_map_log(name, num_shards=4, scale=1,
                                         seed=0)
        for rank, real in enumerate(real_logs[name]):
            assert collectives.diff(traced, real) is None, (name, rank)
            assert collectives.total_bytes(real) == \
                collectives.total_bytes(traced)
        fs = contracts.check_aggregator(name, num_shards=4,
                                        real_calls=real_logs[name])
        assert fs == [], [f.format() for f in fs]


def test_real_view_catches_a_different_log(real_logs):
    from repro_torch.verify import contracts
    real = [list(r) for r in real_logs["gmom"]]
    real[2] = real[2][:-1]
    fs = contracts.check_aggregator("gmom", num_shards=4, real_calls=real)
    assert [f.rule for f in fs] == ["RV202"]
    assert "rank 2" in fs[0].message


@pytest.fixture
def dummy():
    """Register a test-only aggregator; unregister and drop the traces
    after the test."""
    from repro_torch.verify import contracts
    names = []

    def register(name, fn, **meta):
        aggregators.register(name, "test-only dummy", **meta)(fn)
        names.append(name)
        return name

    yield register
    for name in names:
        aggregators._REGISTRY.pop(name, None)
    contracts.clear_trace_cache()


def test_misdeclared_coordinate_wise_rejected_rv201(dummy):
    from repro_torch.verify import contracts

    def misdeclared(stacked, **_kw):
        def leaf(g):
            s = meshctx.psum(torch.sum(g.to(torch.float32), dim=0), "model")
            return (s / g.shape[0]).to(g.dtype)
        return {k: leaf(v) if not isinstance(v, dict)
                else {kk: leaf(vv) for kk, vv in v.items()}
                for k, v in stacked.items()}

    name = dummy("_test_misdeclared", misdeclared,
                 shard_contract="coordinate_wise")
    fs = contracts.check_aggregator(name, num_shards=4)
    assert any(f.rule == "RV201" and "psum" in f.message for f in fs), \
        [f.format() for f in fs]


def test_od_gather_rejected_rv202(dummy):
    from repro_torch.verify import contracts
    from torch.utils._pytree import tree_map

    def gathers_d(stacked, *, shard_spec=None, **_kw):
        def leaf(g):
            gf = g.to(torch.float32)
            if shard_spec is not None and shard_spec.mode == "shard_map" \
                    and g.ndim > 1:
                gf = sa.all_gather(gf, sa.shard_group(shard_spec))[0]
            return torch.mean(gf, dim=0).to(g.dtype)
        return tree_map(leaf, stacked)

    name = dummy("_test_gathers_d", gathers_d, needs_shard_spec=True,
                 shard_contract="norm_based")
    fs = contracts.check_aggregator(name, num_shards=4)
    assert any(f.rule == "RV202" and "d-dependent" in f.message
               for f in fs), [f.format() for f in fs]


def test_shard_stack_sum_rejected_rv203(dummy):
    from repro_torch.verify import contracts
    from torch.utils._pytree import tree_leaves, tree_map

    def stack_sum(stacked, *, shard_spec=None, **_kw):
        leaves = tree_leaves(stacked)
        if shard_spec is not None and shard_spec.mode == "virtual":
            s = shard_spec.num_shards
            parts = torch.stack([
                sum(torch.sum(sa.shard_slice(g, i, s).to(torch.float32) ** 2)
                    for g in leaves if g.ndim > 1) for i in range(s)])
            total = torch.sum(parts, dim=0)      # the order-free sum
        else:
            total = sa.sq_norm(shard_spec, leaves, lead_axes=1)
        return tree_map(lambda g: (torch.mean(g.to(torch.float32), dim=0)
                                   / (1.0 + total)).to(g.dtype), stacked)

    name = dummy("_test_stack_sum", stack_sum, needs_shard_spec=True,
                 shard_contract="norm_based")
    fs = contracts.check_aggregator(name, num_shards=4)
    assert [f.rule for f in fs] == ["RV203"], [f.format() for f in fs]
    assert "5-extent shard stack" in fs[0].message


# --------------------------------------------------------------------------
# the port's verifier stands alone

NO_JAX_CODE = (
    "import sys; from repro_torch.verify import cli; "
    "rc = cli.main(['--strict', '--layer', 'all', '--taint', "
    "'--aggregators', 'krum', 'gmom']); "
    "print(rc, sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')))")


@pytest.fixture(scope="module", autouse=True)
def no_jax_run():
    """One CLI run of every layer in a fresh process (started with the
    file, read by its test): it must import neither jax nor repro."""
    proc = subprocess.Popen(
        [sys.executable, "-c", NO_JAX_CODE], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_verify_imports_neither_jax_nor_repro(no_jax_run):
    out, err = no_jax_run.communicate(timeout=600)
    assert no_jax_run.returncode == 0, err[-2000:]
    assert out.strip().splitlines()[-1] == "0 []", out[-2000:]
