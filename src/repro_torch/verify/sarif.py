"""SARIF 2.1.0 serialization of the port's verifier findings (port of
``repro.verify.sarif``).

Code scanning renders each SARIF result as an annotation on the offending
line.  Layer B/C findings anchor to synthesized paths
(``<aggregator:NAME>``, ``<round:...>``, ``<kernel:...>``) rather than
source files; those are mapped to the port's aggregator registry with the
anchor kept in the message, since SARIF locations must be real artifact
URIs.
"""

from __future__ import annotations

import json
import os

from repro_torch.verify.rules import RULES, Finding

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")

# where synthesized (non-file) anchors point for annotation purposes: the
# registry whose declarations the Layer B/C analyses verify.
_ANCHOR_URI = "src/repro_torch/core/aggregators.py"


def _uri(path: str) -> tuple[str, str]:
    """(artifact uri, message suffix) for a finding path."""
    if path.startswith("<"):
        return _ANCHOR_URI, f" [{path}]"
    cwd = os.getcwd()
    abspath = os.path.abspath(path)
    if abspath.startswith(cwd + os.sep):
        return os.path.relpath(abspath, cwd).replace(os.sep, "/"), ""
    return path.replace(os.sep, "/"), ""


def _result(f: Finding) -> dict:
    uri, suffix = _uri(f.path)
    region = {"startLine": max(f.line, 1),
              "startColumn": max(f.col + 1, 1)}
    if f.end_line:
        region["endLine"] = f.end_line
        region["endColumn"] = max(f.end_col + 1, 1)
    return {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message + suffix},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": uri},
                "region": region,
            },
        }],
    }


def to_sarif(findings: list[Finding]) -> dict:
    used = sorted({f.rule for f in findings})
    rules = [{
        "id": rid,
        "name": rid,
        "shortDescription": {"text": RULES[rid].title},
        "fullDescription": {"text": RULES[rid].motivation},
        "defaultConfiguration": {"level": "error"},
    } for rid in used if rid in RULES]
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.verify",
                "informationUri": "README.md",
                "rules": rules,
            }},
            "results": [_result(f) for f in findings],
        }],
    }


def dump(findings: list[Finding], fp) -> None:
    json.dump(to_sarif(findings), fp, indent=2, ensure_ascii=False)
    fp.write("\n")
