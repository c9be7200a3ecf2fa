"""Rule framework shared by the port's verifier layers (port of
``repro.verify.rules``).

A *rule* is a named invariant with a stable ID (``RV1xx`` = Layer A source
lint, ``RV2xx`` = Layer B traced-graph and launch-budget analysis,
``RV3xx`` = Layer C Byzantine taint / influence analysis), a one-line
title, and the bug class that motivated it.  The IDs are the reference's,
so SARIF output and ignores keep their meaning; each title and motivation
says what the rule means for the port's torch code.  A *finding* is one
violation with a precise source span (Layer A) or a synthesized anchor
(Layers B and C, which report against the offending aggregator, the round
trace or the kernel's plan).

Escape hatch (Layer A): a source line, or the line directly above it,
carrying a comment of the form

    repro_torch: ignore[RV102] <justification>

(after a ``#``) suppresses that rule's findings on that line.  The
justification is REQUIRED: an ignore with an empty justification (or
naming an unknown rule ID) still suppresses, but raises the meta-finding
``RV100``, so the build fails anyway.

Module *markers* (one comment line each, after a ``#``) opt a file into
the scoped rules:

    repro_torch: bit-stable   RV101 + RV105 (fixed-expression-tree modules)
    repro_torch: robust-stat  RV105 only (robust-statistic accumulation)
    repro_torch: train-scan   RV106 (the round loop's carried state)

The spelling is the port's own: the reference's Layer A lints all of
``src/``, the port included, and its ``SourceContext`` reads only its own
``repro:`` spelling, so neither checker reads the other's markers or
ignores.
"""

from __future__ import annotations

import ast
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    layer: str        # "A" (AST lint) | "B" (traced graph / budget) | "C"
    motivation: str   # the bug class this rule encodes


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    end_line: int = 0     # 0 = single-line span
    end_col: int = 0

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


RULES: dict[str, Rule] = {}


def _rule(id: str, title: str, layer: str, motivation: str) -> None:
    RULES[id] = Rule(id=id, title=title, layer=layer, motivation=motivation)


_rule("RV100", "suppression without justification / unknown rule ID", "A",
      "escape-hatch policy: every ignore[...] must say why; there is no "
      "silent baseline suppression")
_rule("RV101", "torch.sum/.sum/.mean over the shard or member axis in a "
      "bit-stable module", "A",
      "a reduction kernel over a short axis picks its own summation order "
      "(it differs between the CPU and the card, and between shapes), so "
      "the shard-local result drifts an ulp from the virtual oracle; "
      "bit-stable modules add the shards with "
      "core/shard_aggregation.chain_sum")
_rule("RV102", "literal seed outside tests/entry points "
      "(repro_torch.random.PRNGKey(<int>), torch.manual_seed(<int>), "
      "Generator().manual_seed(<int>))", "A",
      "a fixed seed inside library code silently turns a per-round random "
      "choice (random_select's subset) into the same choice every round; "
      "seeds and keys come from the caller")
_rule("RV103", "import-time os.environ mutation (CUDA_*, TORCH_*, "
      "PYTORCH_*)", "A",
      "CUDA and the caching allocator read their settings once, when they "
      "initialise: a module that writes them at import reconfigures (or "
      "silently fails to reconfigure) whatever process imports it; write "
      "the environment inside an entry point's call")
_rule("RV104", "aggregators.register call missing metadata "
      "(description / valid shard_contract)", "A",
      "the Layer-B collective analyzer verifies the declared contract: an "
      "undeclared or invalid declaration voids the check")
_rule("RV105", "robust-statistic reduction without float32 accumulation",
      "A",
      "a bf16 mean, vote count or product feeding a median, trim or "
      "Weiszfeld stage loses the paper's concentration bounds; reduce "
      "dtype=torch.float32 (or .to(torch.float32) operands) and cast at "
      "the boundary")
_rule("RV106", "state carried across make_run_rounds' round loop that is "
      "not a TrainState field", "A",
      "bit-exact resume checkpoints exactly TrainState; a value the round "
      "loop carries from one round to the next outside it is lost at a "
      "resume")
_rule("RV107", "StalenessBuffer with non-integer ages or not "
      "TrainState-resident", "A",
      "a float age vector drifts under accumulated where/add rounding and "
      "breaks the exact age > tau drop rule; a buffer outside TrainState is "
      "the RV106 lost-carry bug class for the async path")
_rule("RV201", "coordinate_wise aggregator makes cross-shard "
      "collectives", "B",
      "shard-local contract: coordinate-wise rules touch each parameter "
      "shard on its own, with no collective on the mesh's transport")
_rule("RV202", "norm-based aggregator collective is d-dependent or "
      "oversized", "B",
      "PAPER.md Thm 3: server cost O(md + kd log^3 N) rests on partial "
      "reductions of (k,)/(m,)/(m,m) shape, never O(d) cross-shard "
      "traffic; the real ranks' collectives must also be the traced ones")
_rule("RV203", "aten sum/mean/prod over the shard stack in a traced "
      "aggregator (bit-unstable)", "B",
      "a torch.sum over the shard-stack axis gives the reduction kernel "
      "back the choice of order that the unrolled chain_sum removes")
_rule("RV204", "CUDA round kernel's launch plan inconsistent with the "
      "card's limits or with the kernel's own guards", "B",
      "the dispatcher (resolve_round_backend, linreg_route) and the "
      "kernels' C guards share their limits only by convention, and the "
      "one-pass ring and the persistent grid must fit the H100's shared "
      "memory and SMs")
_rule("RV301", "adversary-tainted value reaches the params/opt_state "
      "update without passing the declared sanitization point", "C",
      "PAPER.md 1.3: Byzantine reports create 'arbitrary and unspecified "
      "dependency'; Thm 3 holds only because the geometric median of "
      "means is the SOLE channel from reports to theta: a tainted codec "
      "scale or buffered report added after aggregation voids it")
_rule("RV302", "adversary-tainted value flows into control state that "
      "outlives the round outside the documented age-discount path", "C",
      "staleness ages and attack timing legitimately couple rounds, but a "
      "report-derived value steering ages, bounds or the metrics history "
      "re-opens the cross-iteration dependency the paper's proof excludes")
_rule("RV303", "aggregator influence certificate inconsistent with its "
      "declared sanitization_point", "C",
      "every report-to-output path must cross a bounded-influence op "
      "(order statistic / rank selection / clip / sign vote / Weiszfeld) "
      "for the robust rules, while the known-unsound rules (mean, "
      "norm_select, norm_clip_mean) must certify unbounded: a stale or "
      "wrong declaration is itself a finding")


# --------------------------------------------------------------------------
# source context: markers + suppressions for one file

IGNORE_RE = re.compile(
    r"#\s*repro_torch:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*)$")
BIT_STABLE_RE = re.compile(r"#\s*repro_torch:\s*bit-stable\b")
ROBUST_STAT_RE = re.compile(r"#\s*repro_torch:\s*robust-stat\b")
TRAIN_SCAN_RE = re.compile(r"#\s*repro_torch:\s*train-scan\b")


@dataclasses.dataclass
class Suppression:
    line: int
    rule_ids: tuple[str, ...]
    justification: str


class SourceContext:
    """One parsed source file plus its markers and suppressions."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.bit_stable = any(BIT_STABLE_RE.search(l) for l in self.lines)
        self.robust_stat = self.bit_stable or any(
            ROBUST_STAT_RE.search(l) for l in self.lines)
        self.train_scan = any(TRAIN_SCAN_RE.search(l) for l in self.lines)
        self.suppressions: list[Suppression] = []
        for i, line in enumerate(self.lines, start=1):
            m = IGNORE_RE.search(line)
            if m is None:
                continue
            ids = tuple(s.strip() for s in m.group(1).split(",") if s.strip())
            self.suppressions.append(
                Suppression(line=i, rule_ids=ids,
                            justification=m.group(2).strip()))

    def suppressed(self, rule: str, line: int) -> bool:
        """True when ``rule`` is ignored at ``line`` (same line or the
        comment line directly above)."""
        for sup in self.suppressions:
            if rule in sup.rule_ids and sup.line in (line, line - 1):
                return True
        return False


def apply_suppressions(findings: list[Finding],
                       ctx: SourceContext) -> list[Finding]:
    """Drop suppressed findings; append RV100 meta-findings for every
    suppression comment that lacks a justification or names an unknown
    rule ID (the suppression still takes effect: RV100 keeps the build
    red, so nothing is silently suppressed)."""
    kept = [f for f in findings
            if not ctx.suppressed(f.rule, f.line)]
    for sup in ctx.suppressions:
        unknown = [r for r in sup.rule_ids if r not in RULES]
        if unknown:
            kept.append(Finding(
                rule="RV100", path=ctx.path, line=sup.line, col=0,
                message=f"ignore[...] names unknown rule ID(s) "
                        f"{', '.join(unknown)}; see --list-rules for the "
                        "catalog"))
        if not sup.justification:
            kept.append(Finding(
                rule="RV100", path=ctx.path, line=sup.line, col=0,
                message="ignore[...] without a justification: state why "
                        "the invariant does not apply here"))
    return kept
