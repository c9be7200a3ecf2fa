"""``python -m repro_torch.verify``: the port's three-layer invariant
checker (port of ``repro.verify.cli``).

Layer A (default: lint all of ``src/repro_torch/``) is pure AST and runs
in milliseconds; Layer B traces every registered aggregator's shard-local
body on an abstract mesh (its collective log against the declared
contract; with ``--full-matrix`` over 2/4/8 shards and against real gloo
ranks too) and audits the CUDA round kernel's launch budget (RV204; on a
machine with the card, the built libraries too); Layer C (``--taint``)
runs the Byzantine taint analysis over the same traces plus the
multi-round trainer.  ``--strict`` turns findings into a non-zero exit
(the gate); without it the checker reports and exits 0.

``--format sarif`` writes the findings as SARIF 2.1.0 for code scanning
(to ``--output`` or stdout, with progress on stderr).
``--audit-ignores`` lists every ignore escape hatch of the port's
spelling with its justification and fails on rule IDs that no longer
exist in the catalog.

Exit codes: 0 clean (or non-strict), 1 findings under ``--strict`` (or
stale ignores under ``--audit-ignores``), 2 internal error (the checker
itself failed, never conflated with a finding).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from repro_torch.verify.rules import RULES, Finding


def _default_src_root() -> str:
    # src/repro_torch/verify/cli.py -> src/repro_torch/
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_layer_a(paths: list[str]) -> list[Finding]:
    from repro_torch.verify.ast_rules import lint_paths
    return lint_paths(paths)


def _names(aggregators_filter):
    from repro_torch.core import aggregators
    names = [n for n in aggregators.available() if not n.startswith("_")]
    if aggregators_filter:
        unknown = sorted(set(aggregators_filter) - set(names))
        if unknown:
            raise SystemExit(f"unknown aggregator(s): {', '.join(unknown)}")
        names = [n for n in names if n in aggregators_filter]
    return names


def run_layer_b(*, aggregators_filter: list[str] | None,
                num_shards_list: list[int], seed: int, real: bool = False,
                log=print) -> list[Finding]:
    import torch
    from repro_torch.verify import contracts, smem

    names = _names(aggregators_filter)
    findings: list[Finding] = []
    for num_shards in num_shards_list:
        real_calls = {}
        if real:
            log(f"[verify] layer B: real collectives of {num_shards} gloo "
                "ranks", flush=True)
            real_calls = contracts.real_collectives(
                names, num_shards=num_shards, seed=seed)
        for name in names:
            log(f"[verify] layer B: {name} x {num_shards} shards",
                flush=True)
            findings.extend(contracts.check_aggregator(
                name, num_shards=num_shards, seed=seed,
                real_calls=real_calls.get(name)))
    findings.extend(smem.check_smem_budget())
    if torch.cuda.is_available():
        log("[verify] layer B: RV204 on the built round libraries",
            flush=True)
        findings.extend(smem.check_library())
    return findings


def run_layer_c(*, aggregators_filter: list[str] | None, full_matrix: bool,
                num_shards: int, seed: int, log=print) -> list[Finding]:
    from repro_torch.verify import taint
    return taint.run_taint(aggregators_filter=aggregators_filter,
                           full_matrix=full_matrix, num_shards=num_shards,
                           seed=seed, log=log)


def audit_ignores(paths: list[str], *, log=print) -> int:
    """List every ignore escape hatch with its justification; exit
    non-zero when one names a rule ID that no longer exists in the
    catalog (a stale suppression is dead weight at best and a masked
    regression at worst)."""
    from repro_torch.verify.ast_rules import iter_python_files
    from repro_torch.verify.rules import SourceContext

    total, stale = 0, 0
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                ctx = SourceContext(path, fh.read())
        except (OSError, SyntaxError):
            continue
        for sup in ctx.suppressions:
            total += 1
            ids = ", ".join(sup.rule_ids)
            just = sup.justification or "(NO JUSTIFICATION)"
            log(f"{path}:{sup.line}: ignore[{ids}] — {just}")
            unknown = [r for r in sup.rule_ids if r not in RULES]
            if unknown:
                stale += 1
                log(f"{path}:{sup.line}: STALE — rule ID(s) "
                    f"{', '.join(unknown)} not in the catalog")
    log(f"[verify] {total} ignore(s), {stale} stale")
    return 1 if stale else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="the port's three-layer invariant checker")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 when any finding survives (the gate)")
    p.add_argument("--layer", choices=["a", "b", "c", "all"], default="all",
                   help="which layer(s) to run (default: all = A+B; "
                        "add Layer C with --taint or --layer c)")
    p.add_argument("--taint", action="store_true",
                   help="also run Layer C (Byzantine taint/influence "
                        "analysis, RV30x)")
    p.add_argument("--paths", nargs="*", default=None,
                   help="files/dirs for Layer A (default: "
                        "src/repro_torch/)")
    p.add_argument("--aggregators", nargs="*", default=None,
                   help="restrict Layers B/C to these registered names")
    p.add_argument("--num-shards", type=int, default=4,
                   help="ranks of the abstract mesh Layer B traces "
                        "(default 4; the harness's leaves divide 2/4/8)")
    p.add_argument("--full-matrix", action="store_true",
                   help="Layer B over 2/4/8 shards, each against real gloo "
                        "ranks' collectives; Layer C over every aggregator "
                        "x codec cell")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the traced aggregation key")
    p.add_argument("--format", choices=["text", "sarif"], default="text",
                   help="findings output format (sarif = SARIF 2.1.0 for "
                        "code scanning)")
    p.add_argument("--output", default=None,
                   help="write the findings report to this file instead of "
                        "stdout")
    p.add_argument("--audit-ignores", action="store_true",
                   help="list every ignore[...] with its justification; "
                        "exit 1 on stale rule IDs")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id} [layer {rule.layer}] {rule.title}")
            print(f"    motivation: {rule.motivation}")
        return 0

    if args.audit_ignores:
        paths = args.paths or [_default_src_root()]
        return audit_ignores(paths)

    # SARIF to stdout must stay machine-parseable: progress and the text
    # rendering of the findings go to stderr in that mode.
    sarif_to_stdout = args.format == "sarif" and args.output is None
    report = sys.stderr if sarif_to_stdout else sys.stdout

    def log(*a, **kw):
        kw.setdefault("file", report)
        print(*a, **kw)

    run_c = args.taint or args.layer == "c"
    findings: list[Finding] = []
    try:
        if args.layer in ("a", "all"):
            t0 = time.perf_counter()
            paths = args.paths or [_default_src_root()]
            a = run_layer_a(paths)
            log(f"[verify] layer A: {len(a)} finding(s) over "
                f"{', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
            findings.extend(a)
        if args.layer in ("b", "all"):
            t0 = time.perf_counter()
            shards = [2, 4, 8] if args.full_matrix else [args.num_shards]
            b = run_layer_b(aggregators_filter=args.aggregators,
                            num_shards_list=shards, seed=args.seed,
                            real=args.full_matrix, log=log)
            log(f"[verify] layer B: {len(b)} finding(s) in "
                f"{time.perf_counter() - t0:.2f} s")
            findings.extend(b)
        if run_c:
            t0 = time.perf_counter()
            c = run_layer_c(aggregators_filter=args.aggregators,
                            full_matrix=args.full_matrix,
                            num_shards=args.num_shards, seed=args.seed,
                            log=log)
            log(f"[verify] layer C: {len(c)} finding(s) in "
                f"{time.perf_counter() - t0:.2f} s")
            findings.extend(c)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        print("[verify] INTERNAL ERROR — the checker itself failed "
              "(this is not a finding)", file=sys.stderr)
        return 2

    for f in findings:
        log(f.format())
    log(f"[verify] {len(findings)} finding(s) total")

    if args.format == "sarif":
        from repro_torch.verify import sarif
        if args.output is not None:
            with open(args.output, "w", encoding="utf-8") as fh:
                sarif.dump(findings, fh)
            log(f"[verify] SARIF written to {args.output}")
        else:
            sarif.dump(findings, sys.stdout)

    if findings and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
