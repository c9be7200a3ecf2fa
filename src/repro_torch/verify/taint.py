"""Layer C: Byzantine taint analysis over the port's traced graphs (port
of ``repro.verify.taint``).

PAPER.md 1.3: Byzantine reports "create arbitrary and unspecified
dependency among the iterations and the aggregated gradients"; the Thm-3
argument holds only because the sanitizing aggregator is the SOLE channel
from adversary-controlled inputs to the model update.  This module makes
that proof obligation a machine-checked invariant of the port: it marks
every adversary-controlled input of a traced computation, runs the
``repro_torch.verify.influence`` label engine over its graph, and
compares what comes out against the registry's declared
``sanitization_point``.

Adversary-controlled sources (the taint roots):

* ``report``        the stacked per-worker gradients (their wire payloads
                    and codec scales are computed from them inside the
                    trace, so they inherit the taint), and buffered stale
                    reports;
* ``age``           per-worker arrival ages in the ``StalenessBuffer``;
* ``attack_state``  the attack schedule's carried memory.

Three check surfaces:

* **per-aggregator certificates** (RV301/RV303): the unsharded
  ``aggregate_reported`` path and the shard-local
  ``make_sharded_aggregate`` body (rank 0 of an abstract mesh, whose
  collectives are graph nodes with their local operands), per wire codec.
  The classification never reads the declaration; it rediscovers the
  bounded-op family from dataflow and compares after.
* **the multi-round trainer** (RV301/RV302): ``make_run_rounds`` with a
  stateful attack schedule, a straggler arrival, the int8 wire and the
  staleness buffer.  Its rounds are a Python loop, so the trace holds
  both rounds unrolled.  Reports must reach params/opt_state only
  BOUNDED, and report taint must not steer state that outlives the round
  (ages, bounds, metrics) outside the gamma^age discount path.
* **run_taint**: the certificates over every aggregator (every codec
  with ``full_matrix``), then the round trace.

The certificate is computed on the plain route (``round_backend=
"reference"``): on the card, ``auto`` sends gmom through the custom op
``repro_torch::gmom_round``, which the engine joins like any op (no
sanitizer is credited by name), so the production trace would certify
nothing.  The plain route is the semantics the kernel is held to:
``chip_smoke.py`` holds the op ``torch.equal`` to
``round.round_aggregate_blocked``, the plain twin of the kernel's
arithmetic, and :func:`production_route` checks that the op stands in the
production trace exactly where the certificate's trace has its Weiszfeld
passes; that equality is what carries the certificate over to the kernel.

The declared/discovered comparison (RV303) runs only on an aggregator's
*canonical* cell, its native codec (or ``none``): a foreign codec can
legitimately change the certificate (``mean`` over sign-decoded +-1
values is bounded).  RV301 (a declared sanitizer bypassed by a RAW path)
applies to every cell.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten_with_path, tree_leaves

from repro_torch import random as prng
from repro_torch.core import aggregators, byzantine, staleness
from repro_torch.core.robust_train import RobustConfig, make_run_rounds
from repro_torch.optim import optimizers
from repro_torch.verify import contracts, influence
from repro_torch.verify.influence import op_name
from repro_torch.verify.rules import Finding

ROUND_ANCHOR = "<round:make_run_rounds>"

# the round-trace harness: every adversary surface at once (stateful
# attack memory, straggler arrivals feeding the staleness buffer, the int8
# wire with per-worker scales)
_ROUND_M = 6
_ROUND_Q = 1
_ROUND_K = 3
_ROUND_BOUND = 2
_ROUND_ROUNDS = 2


def _labels_for(tree, label: influence.Label) -> list[influence.Label]:
    return [label] * len(tree_leaves(tree))


def _keystr(path) -> str:
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(f"[{k.key!r}]")
        elif hasattr(k, "idx"):
            out.append(f"[{k.idx}]")
        elif hasattr(k, "name"):
            out.append(f".{k.name}")
        else:
            out.append(str(k))
    return "".join(out)


def leaf_paths(tree) -> list[str]:
    """Each leaf's path, in the reference's key-string form
    (``['b']['x']``, ``.age``)."""
    flat, _ = tree_flatten_with_path(tree)
    return [_keystr(path) or "<leaf>" for path, _leaf in flat]


@dataclasses.dataclass(frozen=True)
class TaintReport:
    """The influence certificate of one aggregator x codec x mode cell."""
    name: str
    codec: str
    mode: str
    leaves: tuple    # ((path, Label), ...) per output leaf

    @property
    def level(self) -> int:
        return max((l.level for _, l in self.leaves),
                   default=influence.CLEAN)

    @property
    def kinds(self) -> frozenset:
        out = frozenset()
        for _, l in self.leaves:
            out |= l.kinds
        return out

    @property
    def bounded(self) -> bool:
        return self.level < influence.RAW

    def raw_leaves(self):
        return [(p, l) for p, l in self.leaves
                if l.level == influence.RAW]


def _certify(gm, out, args, name, codec, mode, *, fired=None):
    stacked, key = args
    in_labels = _labels_for(stacked, influence.raw("report")) + \
        _labels_for(key, influence.CLEAN_LABEL)
    out_labels = influence.run_graph(gm, in_labels, fired=fired)
    paths = leaf_paths(out)
    if len(paths) != len(out_labels):
        raise RuntimeError(
            f"taint engine returned {len(out_labels)} output labels for "
            f"{len(paths)} output leaves ({name} x {codec} x {mode})")
    return TaintReport(name=name, codec=codec, mode=mode,
                       leaves=tuple(zip(paths, out_labels)))


def classify_aggregator(name: str, *, codec: str | None = None,
                        mode: str = "unsharded", num_shards: int = 4,
                        seed: int = 0) -> TaintReport:
    """Trace one cell and propagate report taint through it.  ``mode``:
    ``"unsharded"`` (``aggregate_reported``) or ``"shard_local"`` (rank 0's
    ``make_sharded_aggregate`` body)."""
    agg = aggregators.get_aggregator(name)
    codec = codec or agg.native_codec or "none"
    if mode == "unsharded":
        gm, out, args = contracts.traced_flat(name, seed=seed, codec=codec)
    elif mode == "shard_local":
        gm, out, _log, args = contracts.traced_shard_map(
            name, num_shards=num_shards, scale=1, seed=seed, codec=codec)
    else:
        raise ValueError(f"unknown taint mode {mode!r}")
    return _certify(gm, out, args, name, codec, mode)


def check_aggregator_taint(name: str, *, codec: str | None = None,
                           mode: str = "unsharded", num_shards: int = 4,
                           seed: int = 0,
                           certify: bool = True) -> list[Finding]:
    """RV301/RV303 findings for one aggregator x codec x mode cell.

    ``certify=False`` (non-canonical codec cells of the full matrix) keeps
    only the RV301 sanitizer-bypass check (see the module docstring)."""
    agg = aggregators.get_aggregator(name)
    declared = agg.sanitization_point
    rep = classify_aggregator(name, codec=codec, mode=mode,
                              num_shards=num_shards, seed=seed)
    anchor = contracts._anchor(name)
    findings: list[Finding] = []

    if declared is not None:
        for path, label in rep.raw_leaves():
            findings.append(Finding(
                rule="RV301", path=anchor, line=0, col=0,
                message=f"declares sanitization_point={declared!r} but "
                        f"output leaf {path} carries RAW worker-report "
                        f"influence ({label.describe()}) under codec "
                        f"{rep.codec!r} / {mode}: a report reaches the "
                        f"update path without passing the sanitizer"))

    if certify:
        if declared is None and rep.bounded:
            findings.append(Finding(
                rule="RV303", path=anchor, line=0, col=0,
                message=f"declares no sanitization_point but every "
                        f"report-to-output path is bounded by dataflow "
                        f"(discovered kinds: {sorted(rep.kinds)}) under "
                        f"codec {rep.codec!r} / {mode}: the declaration "
                        f"is stale: declare the sanitizer"))
        if declared is not None and rep.bounded and \
                declared not in rep.kinds:
            findings.append(Finding(
                rule="RV303", path=anchor, line=0, col=0,
                message=f"declared sanitization_point {declared!r} does "
                        f"not appear on the report-to-output dataflow "
                        f"(discovered bounded ops: {sorted(rep.kinds)}) "
                        f"under codec {rep.codec!r} / {mode}: stale or "
                        f"wrong declaration"))
    return findings


# --------------------------------------------------------------------------
# the production route: where the round kernel's op stands

def _reaches(gm, sources) -> set:
    """The graph's output positions that depend on any of ``sources``."""
    seen, stack = set(sources), list(sources)
    while stack:
        for user in stack.pop().users:
            if user not in seen:
                seen.add(user)
                stack.append(user)
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    return {i for i, o in enumerate(out) if o in seen}


def production_route(name: str = "gmom", *, seed: int = 0) -> dict:
    """The production trace of ``name``'s canonical cell (``auto``, fake
    tensors routed as the card's) against its certificate's trace (the
    plain route): {"ops": the ``repro_torch::gmom_round`` nodes of the
    production trace, "op_reaches" / "weiszfeld_reaches": the output
    positions each trace's op / Weiszfeld steps reach, "outputs": their
    number, "production_fires": Weiszfeld steps the production trace
    still has}."""
    prod, _out, args = contracts.traced_flat(name, seed=seed, route="cuda")
    plain, out, pargs = contracts.traced_flat(name, seed=seed)
    ops = [n for n in prod.graph.nodes if n.op == "call_function"
           and op_name(n) == "gmom_round"]
    fired: list = []
    _certify(plain, out, pargs, name, "", "unsharded", fired=fired)
    prod_fired: list = []
    _certify(prod, out, args, name, "", "production", fired=prod_fired)
    return {"ops": ops, "op_reaches": _reaches(prod, ops),
            "weiszfeld_reaches": _reaches(plain, fired),
            "outputs": len(leaf_paths(out)),
            "production_fires": len(prod_fired)}


def check_production_route(name: str = "gmom", *,
                           seed: int = 0) -> list[Finding]:
    """The round kernel's op is ONE node of the production trace and
    reaches every output leaf, exactly the leaves the certificate's
    Weiszfeld steps reach, and the production trace runs no Weiszfeld
    step of its own: the op replaces the passes the certificate is
    computed on (RV303: a certificate that does not describe the route
    the card runs is a stale declaration of it)."""
    r = production_route(name, seed=seed)
    every = set(range(r["outputs"]))
    if len(r["ops"]) == 1 and r["op_reaches"] == every == \
            r["weiszfeld_reaches"] and r["production_fires"] == 0:
        return []
    return [Finding(
        rule="RV303", path=contracts._anchor(name), line=0, col=0,
        message=f"the production route holds {len(r['ops'])} "
                f"repro_torch::gmom_round node(s) reaching outputs "
                f"{sorted(r['op_reaches'])}, the certificate's Weiszfeld "
                f"steps reach {sorted(r['weiszfeld_reaches'])} of "
                f"{r['outputs']}, and the production trace runs "
                f"{r['production_fires']} Weiszfeld step(s): the kernel "
                f"no longer stands where the certified passes are")]


# --------------------------------------------------------------------------
# the multi-round trainer trace (RV301 + RV302)

def _round_harness(seed: int):
    """(graph, output tree, in_labels) of a 2-round ``make_run_rounds``
    run with every adversary surface live at once."""
    m, q, k = _ROUND_M, _ROUND_Q, _ROUND_K
    cfg = RobustConfig(
        num_workers=m, num_byzantine=q, num_batches=k,
        aggregator="int8_gmom", attack="sign_flip",
        compression="int8_stochastic",
        arrival="straggler_fixed", staleness_bound=_ROUND_BOUND,
        gmom_max_iters=4, gmom_tol=1e-6, round_backend="reference")
    schedule = byzantine.make_schedule(
        "stealth_then_strike", num_workers=m, num_byzantine=q)
    arrival = staleness.make_arrival(
        "straggler_fixed", num_workers=m, staleness_bound=_ROUND_BOUND)

    params = {"w": contracts._fill((4,), 19)}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"]
        return 0.5 * torch.mean(
            torch.square(pred - batch["y"]).to(torch.float32))

    worker_batches = {"x": contracts._fill((m, 2, 4), 23),
                      "y": contracts._fill((m, 2), 29)}
    optimizer = optimizers.sgd(0.1)
    opt_state = optimizer.init(params)
    astate = schedule.init_state("cpu")
    sbuf = staleness.init_buffer(params, m, _ROUND_BOUND)
    key = prng.PRNGKey(seed)
    run = make_run_rounds(loss_fn, optimizer, cfg, schedule=schedule,
                          arrival=arrival, device="cpu")
    holder = {}

    def fn(p, o, b, kk, a, s):
        holder["out"] = run(p, o, b, kk, num_rounds=_ROUND_ROUNDS,
                            attack_state=a, stale_buffer=s)
        return holder["out"]

    args = (params, opt_state, worker_batches, key, astate, sbuf)
    gm = contracts.trace(fn, args)

    # taint roots: the attack schedule's memory, the buffered last reports
    # and the per-worker ages.  Honest batches, params and keys stay CLEAN
    # (marking honest data would, correctly, flag the loss metrics and
    # drown the adversary-specific signal).
    in_labels = (
        _labels_for(params, influence.CLEAN_LABEL)
        + _labels_for(opt_state, influence.CLEAN_LABEL)
        + _labels_for(worker_batches, influence.CLEAN_LABEL)
        + _labels_for(key, influence.CLEAN_LABEL)
        + _labels_for(astate, influence.raw("attack_state"))
        + _labels_for(sbuf.grads, influence.raw("report"))
        + _labels_for(sbuf.age, influence.raw("age"))
        + _labels_for(sbuf.bound, influence.CLEAN_LABEL)
    )
    return gm, holder["out"], in_labels


def classify_round(*, seed: int = 0):
    """[(section, leaf_path, Label), ...] over the round trace's outputs
    (params, opt_state, attack_state, stale_buffer, metrics); the trace
    is kept in ``contracts``' trace cache."""
    key = ("round", seed)
    if key not in contracts._TRACE_CACHE:
        contracts._TRACE_CACHE[key] = _round_harness(seed)
    gm, out, in_labels = contracts._TRACE_CACHE[key]
    out_labels = influence.run_graph(gm, in_labels)
    p_sh, o_sh, a_sh, s_sh, m_sh = out
    sections = [
        ("params", p_sh), ("opt_state", o_sh), ("attack_state", a_sh),
        ("stale_buffer.grads", s_sh.grads), ("stale_buffer.age", s_sh.age),
        ("stale_buffer.bound", s_sh.bound), ("metrics", m_sh),
    ]
    rows = []
    it = iter(out_labels)
    for section, sub in sections:
        for path in leaf_paths(sub):
            rows.append((section, path, next(it)))
    leftover = sum(1 for _ in it)
    if leftover:
        raise RuntimeError(
            f"round-trace section split dropped {leftover} output labels")
    return rows


def check_round_taint(*, seed: int = 0) -> list[Finding]:
    """RV301/RV302 over the multi-round trainer.

    * params / opt_state must never be RAW: reports reach the TrainState
      update only through the aggregator's bounded channel (RV301).
    * metrics outlive the round in TrainState's history: RAW report
      influence there is the cross-iteration dependency PAPER.md 1.3
      excludes (RV302).  BOUNDED is fine (byz/stale counts are capped).
    * the staleness ages and bound may depend on timing (``age``) and on
      attack scheduling (``attack_state``), never on report VALUES: a
      report steering its own future weight outside the gamma^age
      discount is RV302.
    * attack_state and the buffered reports are adversary memory by
      definition: exempt."""
    findings: list[Finding] = []
    for section, path, label in classify_round(seed=seed):
        where = f"{section}{path}"
        if section in ("params", "opt_state"):
            if label.level == influence.RAW:
                findings.append(Finding(
                    rule="RV301", path=ROUND_ANCHOR, line=0, col=0,
                    message=f"{where} carries RAW adversary influence "
                            f"({label.describe()}) after a full round: "
                            f"reports must reach the TrainState update "
                            f"only through the sanitizing aggregator"))
        elif section == "metrics":
            if label.level == influence.RAW:
                findings.append(Finding(
                    rule="RV302", path=ROUND_ANCHOR, line=0, col=0,
                    message=f"{where} carries RAW adversary influence "
                            f"({label.describe()}): the metrics history "
                            f"outlives the round inside TrainState"))
        elif section in ("stale_buffer.age", "stale_buffer.bound"):
            if "report" in label.sources:
                findings.append(Finding(
                    rule="RV302", path=ROUND_ANCHOR, line=0, col=0,
                    message=f"{where} depends on report VALUES "
                            f"({label.describe()}): ages/bounds may couple "
                            f"rounds only through arrival timing and "
                            f"attack scheduling, never through what a "
                            f"worker sent"))
    return findings


# --------------------------------------------------------------------------
# CLI driver

def run_taint(*, aggregators_filter=None, full_matrix: bool = False,
              num_shards: int = 4, seed: int = 0,
              log=print) -> list[Finding]:
    """The Layer C pass: per-aggregator certificates (the native codec,
    or every codec with ``full_matrix``) in both modes, the production
    route of gmom, then the multi-round trace."""
    names = [n for n in aggregators.available() if not n.startswith("_")]
    if aggregators_filter:
        unknown = sorted(set(aggregators_filter) - set(aggregators.available()))
        if unknown:
            raise SystemExit(f"unknown aggregator(s): {', '.join(unknown)}")
        names = [n for n in aggregators.available()
                 if n in aggregators_filter]

    all_codecs = ["none", "sign", "int8_stochastic"]
    findings: list[Finding] = []
    for name in names:
        native = aggregators.get_aggregator(name).native_codec or "none"
        codecs = all_codecs if full_matrix else [native]
        for codec in codecs:
            for mode in ("unsharded", "shard_local"):
                log(f"[verify] layer C: {name} x {codec} x {mode}")
                findings.extend(check_aggregator_taint(
                    name, codec=codec, mode=mode, num_shards=num_shards,
                    seed=seed, certify=(codec == native)))
    if "gmom" in names:
        log("[verify] layer C: gmom's production route (round kernel op)")
        findings.extend(check_production_route("gmom", seed=seed))
    log("[verify] layer C: round trace "
        "(2 rounds x stealth attack x staleness x int8 wire)")
    findings.extend(check_round_taint(seed=seed))
    return findings
