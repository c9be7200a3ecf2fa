"""repro_torch.verify: the port's three-layer invariant checker (port of
``repro.verify``; it imports nothing of ``repro``).

Layer A: AST lint of ``src/repro_torch/`` against the RV1xx rules, read
for torch idioms (no torch import: safe anywhere).  Layer B: every
registered aggregator's shard-local body traced on an abstract mesh, its
collective log held to the declared shard contract (and, on request, to
real ranks' logs), plus the CUDA round kernel's launch-budget audit
(RV2xx).  Layer C: Byzantine taint analysis: every worker-report input is
marked adversary-controlled and propagated through the traced aggregators
and the multi-round trainer; RV3xx fires when taint reaches TrainState
without crossing a bounded-influence sanitizer.  Run as ``python -m
repro_torch.verify`` (``--list-rules`` prints the catalog).
"""

from repro_torch.verify.rules import (RULES, Finding, Rule,  # noqa: F401
                                      SourceContext, apply_suppressions)
from repro_torch.verify.ast_rules import lint_file, lint_paths  # noqa: F401
