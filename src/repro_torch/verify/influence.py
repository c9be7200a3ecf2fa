"""Influence lattice over traced torch graphs for the Layer C Byzantine
taint analysis (port of ``repro.verify.influence``).

This module is the *engine*: it propagates adversary-influence labels
through a traced FX graph (``make_fx`` of a functionalized function:
every node an aten op or a custom op, no mutation and no aliasing), one
node at a time, with no knowledge of aggregator names or registry
metadata.  ``repro_torch.verify.taint`` builds the harnesses (which
inputs are adversary-controlled) and turns the output labels into
RV301/RV302/RV303 findings.

The lattice is the reference's.  Per value, the worst-case influence a
SINGLE Byzantine worker's report can exert on it:

* ``CLEAN``   no dependence on any adversary-controlled input;
* ``BOUNDED`` depends on adversary inputs, but every path crosses an op
  whose per-worker influence is bounded whatever the worker sends (an
  order statistic, a rank selection, a clip, a sign/majority vote, or a
  Weiszfeld reweighting);
* ``RAW``     at least one path lets a single report move the value
  arbitrarily far (sums, means, scale multiplies, dequantize-by-scale).

Each label also carries ``kinds``, the bounded-op families on its
dataflow (``order_stat`` / ``rank_select`` / ``sign_vote`` / ``clip`` /
``weiszfeld``), and ``sources``, the adversary surfaces that feed it
(``report`` / ``age`` / ``attack_state``).

Design rules:

* The DEFAULT transfer of every op is ``join`` (the highest level, the
  union of kinds and sources).  ``mul(RAW, mask)`` stays RAW (masking a
  raw report by a 0/1 mask rescales it, the ``norm_select`` unsoundness),
  and a scale from ``amax`` of a raw report stays RAW.  A custom op
  (``repro_torch::gmom_round``, the abstract mesh's
  ``repro_torch::mesh_transfer``) is a join of its operands too: no op is
  credited by its name.
* Only these ops demote RAW to BOUNDED, each recording its kind:
  ``sort``/``topk``/``kthvalue``/``median`` (order_stat); an index op
  (``index_select``, ``index``, ``gather``) with a tainted index
  (rank_select); ``where`` choosing between clean values (sign_vote); a
  two-sided ``clamp`` whose bounds are not RAW (clip: the reference's
  ``lax.clamp``; a one-sided clamp, ``minimum`` or ``maximum`` bounds
  nothing and joins, as the reference's ``max``/``min``, which is what
  ``jnp.clip`` lowers to).  Comparisons, ``sign``, ``argmin``/``argmax``
  and every boolean value cap at BOUNDED with no kind.
* Ops whose value does not depend on their tensor operands' values
  (``zeros_like``, ``new_empty``, ...) are CLEAN, as the reference's
  jaxpr never names an operand for them.
* The Weiszfeld reweighting is recognized structurally.  The reference
  finds it inside a ``while`` body; here the loop is unrolled to its cap
  (a fake trace's loop stop, ``_device.host_value``), so the pattern is
  the unrolled one: a pass takes distances ``sqrt(...)`` of raw values,
  divides by them (the inverse weights) and multiplies raw points by
  those weights: its result is an iterate of those points.  When a later
  pass takes its distances from that iterate and multiplies the SAME
  points (the same traced node, seen through views and casts) by weights
  from those distances, the product is a Weiszfeld step and is demoted
  to ``weiszfeld``.  One pass of sum_i z_i / ||z_i - c|| around a clean
  ``c`` has no earlier iterate and stays RAW; an iterate's flags never
  credit a product of other points (a later round's reports, a codec's
  scale).  A step that normalizes after its product (sum_i w_i z_i /
  sum_i w_i) is demoted at that division of the product, whose divisor
  carries the same pass's weights.
"""

from __future__ import annotations

import dataclasses
import operator

import torch
from torch.utils._pytree import tree_leaves

CLEAN = 0
BOUNDED = 1
RAW = 2

_LEVEL_NAMES = {CLEAN: "CLEAN", BOUNDED: "BOUNDED", RAW: "RAW"}

#: the closed set of bounded-op families a demotion may record; the
#: registry's ``sanitization_point`` declarations are validated against it.
SANITIZER_KINDS = ("clip", "order_stat", "rank_select", "sign_vote",
                   "weiszfeld")


@dataclasses.dataclass(frozen=True)
class Label:
    level: int = CLEAN
    kinds: frozenset = frozenset()
    sources: frozenset = frozenset()

    def join(self, other: "Label") -> "Label":
        if other is CLEAN_LABEL:
            return self
        if self is CLEAN_LABEL:
            return other
        return Label(level=max(self.level, other.level),
                     kinds=self.kinds | other.kinds,
                     sources=self.sources | other.sources)

    def cap_bounded(self) -> "Label":
        """Influence through a comparison or an index-valued op: the value
        range is tiny, so per-worker influence is bounded, but no
        sanitizer kind is credited (a bool is not a defense)."""
        if self.level <= BOUNDED:
            return self
        return Label(level=BOUNDED, kinds=self.kinds, sources=self.sources)

    def demote(self, kind: str) -> "Label":
        """Pass through a bounded-influence op of family ``kind``."""
        if self.level == CLEAN:
            return self
        return Label(level=BOUNDED, kinds=self.kinds | frozenset({kind}),
                     sources=self.sources)

    def describe(self) -> str:
        parts = [_LEVEL_NAMES[self.level]]
        if self.kinds:
            parts.append("kinds={" + ",".join(sorted(self.kinds)) + "}")
        if self.sources:
            parts.append("sources={" + ",".join(sorted(self.sources)) + "}")
        return " ".join(parts)


CLEAN_LABEL = Label()


def raw(source: str) -> Label:
    return Label(level=RAW, sources=frozenset({source}))


def join_all(labels) -> Label:
    out = CLEAN_LABEL
    for l in labels:
        out = out.join(l)
    return out


# --------------------------------------------------------------------------
# op tables (by the aten op's name, its overload packet)

_ORDER_STAT_OPS = {"sort", "topk", "kthvalue", "median", "nanmedian",
                   "msort", "argsort"}

# bool- or index-valued results: tainted inputs can steer them, but the
# per-worker influence on the VALUE is bounded by the tiny range.
_CAP_OPS = {"lt", "gt", "le", "ge", "eq", "ne", "argmin", "argmax", "all",
            "any", "isfinite", "isnan", "isinf", "sign", "signbit"}

# value selection by index: (operand position, index positions)
_GATHER_OPS = {"index_select": (0, (2,)), "index": (0, (1,)),
               "gather": (0, (2,)), "take": (0, (1,)),
               "take_along_dim": (0, (1,)), "embedding": (0, (1,))}

# results whose values do not depend on their tensor operands' values
_SHAPE_ONLY_OPS = {"zeros_like", "ones_like", "empty_like", "full_like",
                   "new_zeros", "new_ones", "new_empty", "new_full",
                   "new_empty_strided", "scalar_tensor", "zeros", "ones",
                   "empty", "full", "arange", "empty_strided", "sym_size",
                   "sym_numel"}

# products: the Weiszfeld step multiplies raw points by inverse weights
_PRODUCT_OPS = {"mul", "mm", "bmm", "mv", "dot", "matmul", "addmm",
                "baddbmm", "addmv", "vdot", "outer"}

# ops a value passes through unchanged in its points' identity (views,
# copies, casts): the base of a product's operand is found through them
_PASS_OPS = {"view", "view_copy", "_unsafe_view", "reshape", "select",
             "select_copy", "slice", "slice_copy", "unsqueeze",
             "unsqueeze_copy", "squeeze", "squeeze_copy", "expand",
             "expand_copy", "permute", "permute_copy", "transpose",
             "transpose_copy", "t", "t_copy", "alias", "alias_copy",
             "detach", "detach_copy", "_to_copy", "clone", "contiguous",
             "lift_fresh_copy", "unbind", "unbind_copy", "as_strided",
             "as_strided_copy", "getitem", "squeeze_", "unsqueeze_"}


def op_name(node) -> str:
    """The aten (or custom) op's name without namespace and overload
    (``aten.sum.dim_IntList`` -> ``sum``); ``getitem`` for a tuple
    element; the node's op kind otherwise."""
    if node.op != "call_function":
        return node.op
    target = node.target
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _nodes_in(arg):
    """The FX nodes among an op's (possibly nested) arguments, in order."""
    import torch.fx as fx
    return [a for a in tree_leaves(arg, is_leaf=lambda x: isinstance(
        x, fx.Node)) if isinstance(a, fx.Node)]


def _is_bool(node) -> bool:
    val = node.meta.get("val")
    return isinstance(val, torch.Tensor) and val.dtype == torch.bool


class _State:
    """Labels and Weiszfeld flags of every node of one graph."""

    def __init__(self):
        self.label: dict = {}
        self.flags: dict = {}
        self.steps: dict = {}    # Weiszfeld products -> their points

    def lab(self, arg) -> Label:
        return join_all(self.label.get(n, CLEAN_LABEL)
                        for n in _nodes_in(arg))

    def fl(self, arg) -> frozenset:
        out = frozenset()
        for n in _nodes_in(arg):
            out |= self.flags.get(n, frozenset())
        return out


def _base(node):
    """The node a value is a view, copy or cast of (its points)."""
    while node.op == "call_function" and op_name(node) in _PASS_OPS \
            and node.args:
        node = node.args[0]
    return node


def _transfer(node, name: str, st: _State) -> Label:
    """The label of a first-order op (every result the same)."""
    args = list(node.args) + list(node.kwargs.values())
    if name in _SHAPE_ONLY_OPS:
        return CLEAN_LABEL
    ins = [st.lab(a) for a in args]
    if name in _ORDER_STAT_OPS:
        # any single report moves the output by at most one rank slot;
        # covers the sorted values and the index output alike
        return join_all(ins).demote("order_stat")
    if name in _CAP_OPS:
        return join_all(ins).cap_bounded()
    if name == "clamp":
        lo = node.kwargs.get("min", node.args[1] if len(node.args) > 1
                             else None)
        hi = node.kwargs.get("max", node.args[2] if len(node.args) > 2
                             else None)
        if lo is not None and hi is not None and \
                st.lab(lo).level < RAW and st.lab(hi).level < RAW:
            return join_all(ins).demote("clip")
        return join_all(ins)
    if name == "where" and len(node.args) == 3:
        pred = st.lab(node.args[0])
        vals = [st.lab(node.args[1]), st.lab(node.args[2])]
        if all(v.level == CLEAN for v in vals):
            # where(vote_condition, +c, -c): the report only steers a
            # choice among clean constants, the majority-vote shape
            if pred.level == CLEAN:
                return CLEAN_LABEL
            return Label(level=BOUNDED,
                         kinds=pred.kinds | frozenset({"sign_vote"}),
                         sources=pred.sources)
        return join_all(vals).join(pred.cap_bounded())
    if name in _GATHER_OPS:
        opnd, idx_pos = _GATHER_OPS[name]
        operand = st.lab(node.args[opnd])
        idx = join_all(st.lab(node.args[i]) for i in idx_pos
                       if i < len(node.args))
        rest = join_all(st.lab(a) for i, a in enumerate(node.args)
                        if i != opnd and i not in idx_pos)
        if idx.level == CLEAN:
            return operand.join(rest)
        # a tainted index picks WHICH row wins, not its value: bounded,
        # credited as rank selection (krum's winner-take; the reference's
        # documented caveat: the selection score must itself be robust)
        return Label(level=BOUNDED,
                     kinds=operand.kinds | idx.kinds
                     | frozenset({"rank_select"}),
                     sources=operand.sources | idx.sources).join(rest)
    return join_all(ins)


def _weiszfeld(node, name: str, st: _State, label: Label):
    """(label, flags) of ``node`` with the unrolled Weiszfeld pattern
    (module docstring): flags ("dist",), ("inv",) for a first pass,
    ("wprod", points) for its product, ("iter_dist", points) and
    ("iter_inv", points) for a pass that reads that iterate."""
    args = list(node.args) + list(node.kwargs.values())
    flags = st.fl(args)
    if name == "sqrt" and node.args and st.lab(node.args[0]).level == RAW:
        add = {("dist", None)}
        add |= {("iter_dist", b) for tag, b in st.fl(node.args[0])
                if tag == "wprod"}
        return label, flags | add
    if name == "reciprocal" and node.args:
        div = st.fl(node.args[0])
        add = {("inv", None) for tag, _ in div if tag == "dist"}
        add |= {("iter_inv", b) for tag, b in div if tag == "iter_dist"}
        return label, flags | add
    if name == "div" and len(node.args) == 2:
        div = st.fl(node.args[1])
        add = {("inv", None) for tag, _ in div if tag == "dist"}
        add |= {("iter_inv", b) for tag, b in div if tag == "iter_dist"}
        # sum_i w_i z_i / sum_i w_i: a step normalized after its product
        num = _base(node.args[0]) if hasattr(node.args[0], "op") else None
        if label.level == RAW and num in st.steps and \
                ("iter_inv", st.steps[num]) in div:
            label = label.demote("weiszfeld")
        return label, flags | add
    if name in _PRODUCT_OPS:
        opnds = [a for a in node.args
                 if hasattr(a, "op")][-2:]          # addmm: the two factors
        if len(opnds) != 2:
            return label, flags
        add, fire = set(), False
        for w, p in ((opnds[0], opnds[1]), (opnds[1], opnds[0])):
            if st.lab(p).level != RAW:
                continue
            wf = st.fl(w)
            base = _base(p)
            if any(tag in ("inv", "iter_inv") for tag, _ in wf):
                add.add(("wprod", base))
            if ("iter_inv", base) in wf:
                fire = base
        if fire is not False and label.level == RAW:
            label = label.demote("weiszfeld")
            st.steps[node] = fire
        return label, flags | add
    return label, flags


def run_graph(gm, in_labels: list[Label], *,
              fired: list | None = None) -> list[Label]:
    """Propagate labels through a traced graph module.

    ``in_labels`` matches the graph's placeholders, in order; constants
    (``get_attr``) are CLEAN.  Returns one label per output of the graph
    (its flat output list).  ``fired`` collects the nodes demoted as
    Weiszfeld steps."""
    graph = getattr(gm, "graph", gm)
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    if len(in_labels) != len(placeholders):
        raise ValueError(
            f"label/placeholder arity mismatch: {len(in_labels)} labels "
            f"for {len(placeholders)} placeholders")
    st = _State()
    for n, lab in zip(placeholders, in_labels):
        st.label[n] = lab
        st.flags[n] = frozenset()
    out = None
    for node in graph.nodes:
        if node.op == "output":
            out = node.args[0]
            continue
        if node.op != "call_function":
            continue
        name = op_name(node)
        if name == "getitem":
            label = st.lab(node.args[0])
            flags = st.fl(node.args[0])
        else:
            label = _transfer(node, name, st)
            before = label
            label, flags = _weiszfeld(node, name, st, label)
            if fired is not None and label is not before:
                fired.append(node)
        if _is_bool(node):
            # a boolean's VALUE range is {0, 1}: whatever fed it, one
            # worker's per-value influence is bounded
            label = label.cap_bounded()
        st.label[node] = label
        st.flags[node] = flags
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [st.lab(o) for o in outs]
