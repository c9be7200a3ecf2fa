"""Layer A: the AST contract lint of the port's torch code (rules
RV101-RV107; port of ``repro.verify.ast_rules``).

Pure ``ast``: no import of torch, no execution of the linted code, so the
lint runs in milliseconds over all of ``src/repro_torch/`` and is safe to
point at arbitrary fixture files.  Each rule is a function
``SourceContext -> [Finding]`` reading the port's own idiom (``torch.sum``
and the ``.sum``/``.mean`` methods, ``dim=``, ``.to(torch.float32)``,
``manual_seed``, the Python round loop of ``make_run_rounds``);
:func:`lint_file` runs them all and applies the ignore[...] escape hatch.
"""

from __future__ import annotations

import ast
import os

from repro_torch.verify.rules import Finding, SourceContext, \
    apply_suppressions

_AXIS_FNS = ("sum", "mean")
# module roots whose sum/mean take the tensor first (function form); any
# other base is a tensor's method (x.sum(0))
_FN_ROOTS = ("torch", "np", "numpy")
_DOT_FNS = ("matmul", "mm", "bmm", "mv", "einsum", "tensordot", "dot",
            "vdot", "inner")
_ENV_MUTATORS = ("setdefault", "update", "pop", "clear")
_SEED_CALLS = ("PRNGKey", "manual_seed", "manual_seed_all")


def _attr_chain(node: ast.AST) -> list[str]:
    """``torch.cuda.manual_seed`` -> ["torch", "cuda", "manual_seed"]; []
    when the expression is not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _finding(rule: str, ctx: SourceContext, node: ast.AST,
             message: str) -> Finding:
    return Finding(
        rule=rule, path=ctx.path, line=node.lineno, col=node.col_offset,
        end_line=getattr(node, "end_lineno", 0) or 0,
        end_col=getattr(node, "end_col_offset", 0) or 0, message=message)


def _is_int(node: ast.AST | None, value: int | None = None) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)
            and (value is None or node.value == value))


def _dim_has_zero(node: ast.AST | None) -> bool:
    """dim=0 or dim=(0, ...) with literal ints (negative and non-literal
    dims are out of scope: the shard/member axis is dim 0 by the stacking
    convention)."""
    if node is None:
        return False
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_is_int(e, 0) for e in node.elts)
    return _is_int(node, 0)


def _reduce_call(call: ast.Call):
    """(function name, operand nodes, dim node) of a sum/mean call in
    either form, ``torch.sum(x, 0)`` / ``torch.sum(x, dim=0)`` or
    ``x.sum(0)`` / ``x.mean(dim=0)``; None for any other call."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr in _AXIS_FNS):
        return None
    dim = next((kw.value for kw in call.keywords
                if kw.arg in ("dim", "axis")), None)
    chain = _attr_chain(call.func)
    if chain and chain[0] in _FN_ROOTS:
        if len(chain) != 2:
            return None
        if dim is None and len(call.args) >= 2:
            dim = call.args[1]
        return call.func.attr, list(call.args[:1]), dim
    if dim is None and call.args:
        dim = call.args[0]
    return call.func.attr, [call.func.value], dim


def _is_f32(node: ast.AST) -> bool:
    """``torch.float32`` / ``torch.float`` / ``"float32"``."""
    if isinstance(node, ast.Constant) and node.value == "float32":
        return True
    chain = _attr_chain(node)
    return bool(chain) and chain[-1] in ("float32", "float") and \
        chain[0] in ("torch", "np", "numpy")


def _subtree_has_f32_cast(node: ast.AST) -> bool:
    """True when the operand subtree visibly up-casts to float32:
    ``x.to(torch.float32)`` / ``x.float()`` / ``dtype=torch.float32``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Attribute) and sub.func.attr == "float" \
                and not sub.args:
            return True
        if isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in ("to", "type") and \
                any(_is_f32(a) for a in sub.args):
            return True
        if any(kw.arg == "dtype" and _is_f32(kw.value)
               for kw in sub.keywords):
            return True
    return False


def _call_accumulates_f32(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" and _is_f32(kw.value)
               for kw in call.keywords)


# --------------------------------------------------------------------------
# RV101: no torch.sum/.sum/.mean over the shard/member axis in bit-stable
# modules (add the shards with the chain of core/shard_aggregation.py).

def rv101(ctx: SourceContext) -> list[Finding]:
    if not ctx.bit_stable:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        red = _reduce_call(node)
        if red is None or not _dim_has_zero(red[2]):
            continue
        out.append(_finding(
            "RV101", ctx, node,
            f"{red[0]}(..., dim=0) over the shard/member axis in a "
            "bit-stable module: the reduction kernel picks its own order "
            "of the adds; use blocked_partial_sum / the unrolled chain_sum "
            "(core/shard_aggregation.py)"))
    return out


# --------------------------------------------------------------------------
# RV102: no literal seed outside entry points.  Exempt regions: functions
# named ``main`` and the ``if __name__ == "__main__":`` block.

def _is_main_guard(node: ast.AST) -> bool:
    if not isinstance(node, ast.If):
        return False
    t = node.test
    return (isinstance(t, ast.Compare)
            and isinstance(t.left, ast.Name) and t.left.id == "__name__"
            and any(isinstance(c, ast.Constant) and c.value == "__main__"
                    for c in t.comparators))


def _exempt_spans(ctx: SourceContext) -> list[tuple[int, int]]:
    spans = []
    for node in ast.walk(ctx.tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "main") or _is_main_guard(node):
            spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


def rv102(ctx: SourceContext) -> list[Finding]:
    spans = _exempt_spans(ctx)
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SEED_CALLS):
            continue
        if not (node.args and _is_int(node.args[0])):
            continue
        if any(lo <= node.lineno <= hi for lo, hi in spans):
            continue
        what = ".".join(_attr_chain(node.func)) or f"<...>.{node.func.attr}"
        out.append(_finding(
            "RV102", ctx, node,
            f"literal {what}({node.args[0].value!r}) outside an entry "
            "point: thread the key or seed from the caller (the fixed "
            "random_select subset bug class)"))
    return out


# --------------------------------------------------------------------------
# RV103: no import-time os.environ mutation.  Import-time = any statement
# that runs when the module is imported: module body, top-level
# if/try/with/for bodies, and class bodies; everything but function bodies.

def _is_environ(node: ast.AST) -> bool:
    return _attr_chain(node)[-2:] == ["os", "environ"] or \
        _attr_chain(node) == ["environ"]


class _ImportTimeEnvVisitor(ast.NodeVisitor):
    def __init__(self, ctx: SourceContext):
        self.ctx = ctx
        self.out: list[Finding] = []

    # runtime-only scopes are not descended into
    def visit_FunctionDef(self, node):       # noqa: N802
        pass

    def visit_AsyncFunctionDef(self, node):  # noqa: N802
        pass

    def visit_Lambda(self, node):            # noqa: N802
        pass

    def _flag(self, node, what: str):
        self.out.append(_finding(
            "RV103", self.ctx, node,
            f"import-time {what}: CUDA and the caching allocator read "
            "CUDA_*/TORCH_*/PYTORCH_* once, at initialisation, so an "
            "import reconfigures (or silently fails to reconfigure) the "
            "importing process; write the environment inside an explicit "
            "entry-point call instead"))

    def visit_Assign(self, node):            # noqa: N802
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript) and _is_environ(tgt.value):
                self._flag(node, "os.environ[...] assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node):         # noqa: N802
        if isinstance(node.target, ast.Subscript) \
                and _is_environ(node.target.value):
            self._flag(node, "os.environ[...] augmented assignment")
        self.generic_visit(node)

    def visit_Delete(self, node):            # noqa: N802
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript) and _is_environ(tgt.value):
                self._flag(node, "del os.environ[...]")
        self.generic_visit(node)

    def visit_Call(self, node):              # noqa: N802
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _ENV_MUTATORS \
                and _is_environ(node.func.value):
            self._flag(node, f"os.environ.{node.func.attr}(...)")
        if _attr_chain(node.func)[-2:] == ["os", "putenv"]:
            self._flag(node, "os.putenv(...)")
        self.generic_visit(node)


def rv103(ctx: SourceContext) -> list[Finding]:
    v = _ImportTimeEnvVisitor(ctx)
    v.visit(ctx.tree)
    return v.out


# --------------------------------------------------------------------------
# RV104: every aggregators.register call declares a non-empty description
# and a valid literal shard_contract.

_SHARD_CONTRACTS = ("coordinate_wise", "norm_based", "whole_gradient")


def _is_aggregator_register(call: ast.Call, ctx: SourceContext) -> bool:
    chain = _attr_chain(call.func)
    if chain[-2:] == ["aggregators", "register"]:
        return True
    # a bare register(...) counts only inside the registry module itself
    return chain == ["register"] and \
        ctx.path.replace(os.sep, "/").endswith("core/aggregators.py")


def rv104(ctx: SourceContext) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _is_aggregator_register(node, ctx)):
            continue
        desc = node.args[1] if len(node.args) >= 2 else next(
            (kw.value for kw in node.keywords if kw.arg == "description"),
            None)
        if desc is None or (isinstance(desc, ast.Constant)
                            and not str(desc.value).strip()):
            out.append(_finding(
                "RV104", ctx, node,
                "aggregators.register call without a (non-empty) "
                "description: the registry is the documentation surface"))
        contract = next(
            (kw.value for kw in node.keywords if kw.arg == "shard_contract"),
            None)
        if contract is None:
            out.append(_finding(
                "RV104", ctx, node,
                "aggregators.register call without an explicit "
                f"shard_contract= (one of {_SHARD_CONTRACTS}): the Layer-B "
                "collective analyzer verifies the declared contract"))
        elif not (isinstance(contract, ast.Constant)
                  and contract.value in _SHARD_CONTRACTS):
            out.append(_finding(
                "RV104", ctx, node,
                "shard_contract must be a literal from "
                f"{_SHARD_CONTRACTS} so the contract is statically known"))
    return out


# --------------------------------------------------------------------------
# RV105: reductions feeding a robust statistic accumulate in float32.
# Scope: robust-stat (and bit-stable) marked modules.  Two shapes:
#   (a) matmul-like calls need an operand visibly cast to float32;
#   (b) member-axis sums/means (dim 0) need dtype=torch.float32 or an
#       operand visibly cast to float32.

def rv105(ctx: SourceContext) -> list[Finding]:
    if not ctx.robust_stat:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if len(chain) >= 2 and chain[0] == "torch" and chain[-1] in _DOT_FNS:
            if not (_call_accumulates_f32(node) or any(
                    _subtree_has_f32_cast(a) for a in node.args)):
                out.append(_finding(
                    "RV105", ctx, node,
                    f"{'.'.join(chain)} feeding a robust statistic without "
                    "a float32 accumulator: cast the operands "
                    ".to(torch.float32)"))
            continue
        red = _reduce_call(node)
        if red is None or not _dim_has_zero(red[2]):
            continue
        if not (_call_accumulates_f32(node) or any(
                _subtree_has_f32_cast(a) for a in red[1])):
            out.append(_finding(
                "RV105", ctx, node,
                f"{red[0]}(..., dim=0) over the member axis without "
                "float32 accumulation: pass dtype=torch.float32 or reduce "
                ".to(torch.float32) operands and cast back at the "
                "boundary"))
    return out


# --------------------------------------------------------------------------
# RV106: state the round loop carries from one round to the next must be
# TrainState fields.  The round loop is a ``for`` over ``range(...)`` of a
# name that says rounds (``range(num_rounds)``) in a train-scan module; a
# name it carries is one the loop body reads before it assigns it, or
# collects into (``rows.append(row)``: the metrics history).

_CARRY_ALIASES = {"astate": "attack_state", "buf": "stale_buffer",
                  "rows": "history"}
_COLLECTORS = ("append", "extend", "insert")


def train_state_fields() -> tuple[str, ...]:
    """TrainState's field names, parsed from the port's
    core/train_state.py (no import: Layer A never executes repo code)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "core", "train_state.py")
    with open(os.path.normpath(path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "TrainState":
            return tuple(
                stmt.target.id for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name))
    raise RuntimeError("TrainState class not found in core/train_state.py")


def _is_round_loop(node: ast.AST) -> bool:
    if not (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)
            and _attr_chain(node.iter.func) == ["range"]):
        return False
    return any(isinstance(n, ast.Name) and "round" in n.id
               for a in node.iter.args for n in ast.walk(a))


def _loop_carries(loop: ast.For):
    """(carried plain names -> first node, carried non-name targets): a
    plain name the body reads before its first assignment there and also
    assigns (or collects into: the metrics rows); a subscript/attribute
    target whose base name the body has not assigned before it."""
    body = ast.Module(body=loop.body, type_ignores=[])
    # a statement's right-hand side runs before its targets are stored
    at_end = {}
    for stmt in ast.walk(body):
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                for n in ast.walk(t):
                    at_end[id(n)] = (stmt.end_lineno, stmt.end_col_offset)
    events = []          # (position, kind, name, node)
    for sub in ast.walk(body):
        pos = at_end.get(id(sub), (getattr(sub, "lineno", 0),
                                   getattr(sub, "col_offset", 0)))
        if isinstance(sub, ast.AugAssign) and \
                isinstance(sub.target, ast.Name):
            events.append(((sub.lineno, sub.col_offset), "load",
                           sub.target.id, sub.target))
        if isinstance(sub, ast.Name) and id(sub) not in at_end:
            if isinstance(sub.ctx, ast.Load):
                events.append((pos, "load", sub.id, sub))
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            events.append((pos, "store", sub.id, sub))
        elif isinstance(sub, (ast.Subscript, ast.Attribute)) and \
                isinstance(sub.ctx, ast.Store):
            base = sub.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name):
                events.append((pos, "store_elt", base.id, sub))
        elif isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _COLLECTORS and \
                isinstance(sub.func.value, ast.Name):
            events.append((pos, "collect", sub.func.value.id,
                           sub.func.value))
    events.sort(key=lambda e: e[0])
    stored, first_load, elts = set(), {}, []
    for _, kind, name, node in events:
        if kind == "store":
            stored.add(name)
        elif kind == "load":
            if name not in stored:
                first_load.setdefault(name, node)
        elif kind == "collect":
            first_load.setdefault(name, node)
        elif kind == "store_elt" and name not in stored:
            elts.append(node)
    assigned = {e[2] for e in events if e[1] in ("store", "collect")}
    target_names = {n.id for n in ast.walk(loop.target)
                    if isinstance(n, ast.Name)}
    carried = {k: v for k, v in first_load.items()
               if k in assigned and k not in target_names}
    return carried, elts


def rv106(ctx: SourceContext,
          fields: tuple[str, ...] | None = None) -> list[Finding]:
    if not ctx.train_scan:
        return []
    if fields is None:
        fields = train_state_fields()
    out = []
    for node in ast.walk(ctx.tree):
        if not _is_round_loop(node):
            continue
        carried, elts = _loop_carries(node)
        for name, at in sorted(carried.items(),
                               key=lambda kv: (kv[1].lineno,
                                               kv[1].col_offset)):
            if _CARRY_ALIASES.get(name, name) in fields:
                continue
            out.append(_finding(
                "RV106", ctx, at,
                f"round-loop carry {name!r} does not map to a TrainState "
                f"field {fields}: state carried from round to round "
                "outside TrainState is lost at a bit-exact resume; add the "
                "field to TrainState (fixed structure, tensor leaves)"))
        for at in elts:
            out.append(_finding(
                "RV106", ctx, at,
                "round-loop carry element is not a plain name: carry "
                "exactly the TrainState-backed values so the checkpoint "
                "contract stays auditable"))
    return out


# --------------------------------------------------------------------------
# RV107: StalenessBuffer integrity: every construction passes an
# integer-dtype age vector, and the buffer stays TrainState-resident (a
# ``stale_buffer`` field must exist).

_INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "long", "int")


def _subtree_has_int_dtype(node: ast.AST) -> bool:
    """True when the age-argument subtree visibly pins an integer dtype:
    ``torch.int32`` as a dtype argument, a ``.to`` target, or
    ``.int()``/``.long()``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and sub.value in _INT_DTYPES[:8]:
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in ("int", "long") and not sub.args:
            return True
        chain = _attr_chain(sub)
        if len(chain) >= 2 and chain[0] == "torch" and \
                chain[-1] in _INT_DTYPES[:8] + ("long", "int"):
            return True
    return False


def _buffer_age_arg(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "age":
            return kw.value
    if len(call.args) >= 2:       # StalenessBuffer(grads, age, bound)
        return call.args[1]
    return None


def rv107(ctx: SourceContext,
          fields: tuple[str, ...] | None = None) -> list[Finding]:
    out = []
    first_ctor = None
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _attr_chain(node.func)[-1:] != ["StalenessBuffer"]:
            continue
        if first_ctor is None:
            first_ctor = node
        age = _buffer_age_arg(node)
        if age is None:
            out.append(_finding(
                "RV107", ctx, node,
                "StalenessBuffer constructed without an age vector: the "
                "bounded-staleness drop rule is undefined without "
                "per-worker ages"))
        elif not _subtree_has_int_dtype(age):
            out.append(_finding(
                "RV107", ctx, node,
                "StalenessBuffer age vector without a visible integer "
                "dtype (dtype=torch.int32 / .to(torch.int32)): float ages "
                "drift under accumulated arithmetic and break the exact "
                "age > tau drop rule"))
    if first_ctor is not None:
        if fields is None:
            fields = train_state_fields()
        if "stale_buffer" not in fields:
            out.append(_finding(
                "RV107", ctx, first_ctor,
                "StalenessBuffer is constructed but TrainState has no "
                "'stale_buffer' field: buffer state outside TrainState "
                "breaks bit-exact resume"))
    return out


# --------------------------------------------------------------------------
# driver

_ALL_RULES = (rv101, rv102, rv103, rv104, rv105, rv106, rv107)


def lint_file(path: str, src: str | None = None) -> list[Finding]:
    if src is None:
        with open(path) as f:
            src = f.read()
    ctx = SourceContext(path, src)
    findings: list[Finding] = []
    for rule in _ALL_RULES:
        findings.extend(rule(ctx))
    return sorted(apply_suppressions(findings, ctx),
                  key=lambda f: (f.line, f.col, f.rule))


def iter_python_files(paths: list[str]) -> list[str]:
    """Every ``.py`` file under each path, sorted, ``__pycache__`` pruned
    (shared by the linter and the ``--audit-ignores`` suppression audit)."""
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            files += [os.path.join(dirpath, f) for f in sorted(filenames)
                      if f.endswith(".py")]
    return sorted(set(files))


def lint_paths(paths: list[str]) -> list[Finding]:
    """Lint every ``.py`` file under each path (files are linted as-is)."""
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f))
    return findings
