"""Golden metric traces for the port (PyTorch port of
``repro.sim.goldens``).

The port keeps its own copies of the reference's eleven golden traces
under ``sim/goldens/`` (byte-identical to ``repro``'s; a test checks it)
and holds its engine against them with ``compare_traces`` (rtol 1e-3,
atol 1e-6: the port draws the reference's PRNG bits, but its float
reductions run in other orders).  The goldens are recorded by the
reference only; the port never re-records them.  ``trace_bytes`` is the
reference's canonical serialization, so a resumed run is held against a
straight one byte for byte.
"""

from __future__ import annotations

import json
import os
import tempfile

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
_SIG_DIGITS = 6


def canonicalize(obj):
    """Round all floats to 6 significant digits, recursively."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, float):
        return float(f"{obj:.{_SIG_DIGITS}g}")
    if isinstance(obj, dict):
        return {k: canonicalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canonicalize(v) for v in obj]
    return obj


def trace_bytes(trace: dict) -> bytes:
    """The canonical bytes of a trace (the golden files' format)."""
    return (json.dumps(canonicalize(trace), sort_keys=True,
                       separators=(",", ": "), indent=0) + "\n").encode()


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, name.replace("/", "__") + ".json")


def load_golden(name: str) -> dict:
    with open(golden_path(name), "rb") as f:
        return json.load(f)


def compare_traces(trace: dict, golden: dict, *, rtol: float = 1e-3,
                   atol: float = 1e-6, _path: str = "") -> list[str]:
    """Structural comparison with float tolerance; returns the mismatch
    list (empty == match)."""
    trace = canonicalize(trace)
    golden = canonicalize(golden)

    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                if k not in a or k not in b:
                    yield f"{path}.{k}: present in only one trace"
                else:
                    yield from walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                yield f"{path}: length {len(a)} vs {len(b)}"
            else:
                for i, (x, y) in enumerate(zip(a, b)):
                    yield from walk(x, y, f"{path}[{i}]")
        elif isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and not isinstance(a, bool) and not isinstance(b, bool):
            if abs(a - b) > atol + rtol * max(abs(a), abs(b)):
                yield f"{path}: {a} != {b}"
        elif a != b:
            yield f"{path}: {a!r} != {b!r}"

    return list(walk(trace, golden, _path or "trace"))


def check_all(*, round_backend: str = "auto", device=None
              ) -> dict[str, list[str]]:
    """Run every golden scenario on ``device``; {name: mismatches}."""
    from repro_torch.sim.engine import run_scenario
    from repro_torch.sim.scenarios import golden_scenarios
    return {sc.name: compare_traces(
                run_scenario(sc, round_backend=round_backend, device=device),
                load_golden(sc.name))
            for sc in golden_scenarios()}


# The interrupted-resume probe runs a STATEFUL schedule: its adversary
# memory (EMA / latch) is exactly what a params-only resume would lose.
RESUME_CHECK_SCENARIO = "linreg/gmom/sign_flip/stealth_then_strike"


def check_resume_replay(name: str = RESUME_CHECK_SCENARIO, *,
                        device=None) -> list[str]:
    """Interrupt a checkpointed replay mid-run, resume it from the saved
    TrainState, and compare the stitched trace against the golden."""
    from repro_torch.sim.engine import replay_scenario
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(name)
    half = max(1, sc.rounds // 2)
    with tempfile.TemporaryDirectory(prefix="golden_resume_") as ckpt_dir:
        replay_scenario(sc, ckpt_dir, rounds=half, ckpt_every=5,
                        device=device)                             # "crash"
        trace = replay_scenario(sc, ckpt_dir, ckpt_every=5,
                                device=device)                     # resume
    return compare_traces(trace, load_golden(name))


# The campaigns whose resume the reference holds byte for byte against a
# straight run: the compressed wire and the staleness buffer (the buffer's
# rows and ages must ride the checkpoint).
BIT_EXACT_RESUME_SCENARIOS = ("linreg/sign_majority_static",
                              "linreg/gmom/sign_flip/rotating/stale")


def check_resume_bit_exact(name: str, *, crash_at: int = 19,
                           ckpt_every: int = 7, device=None) -> list[str]:
    """Run ``name`` straight, then as a checkpointed replay interrupted
    after ``crash_at`` rounds and resumed (checkpoints every
    ``ckpt_every``); the resumed trace must equal the straight one byte
    for byte (``trace_bytes``) and match the golden.  Returns the
    mismatch list (empty == bit-exact resume)."""
    from repro_torch.sim.engine import replay_scenario, run_scenario
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(name)
    straight = trace_bytes(run_scenario(sc, device=device))
    with tempfile.TemporaryDirectory(prefix="golden_resume_") as ckpt_dir:
        replay_scenario(sc, ckpt_dir, rounds=crash_at, ckpt_every=ckpt_every,
                        device=device)                             # "crash"
        trace = replay_scenario(sc, ckpt_dir, ckpt_every=ckpt_every,
                                device=device)                     # resume
    bad = [] if trace_bytes(trace) == straight else [
        f"{name}: the resumed trace's bytes differ from the straight run's"]
    return bad + compare_traces(trace, load_golden(name))
