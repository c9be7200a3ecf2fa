"""Device resolution for the port's entry points.

An entry point takes ``device=None``, which means the CUDA card.  Without
a card it raises instead of quietly running on the CPU; the caller asks
for the CPU explicitly with ``device="cpu"`` (the CPU tests do).

The reference computes in float32 everywhere, so TF32 matmuls are refused,
and bf16 matmuls reduce in float32.

The dry run (``launch.dryrun``) traces one rank's step on fake tensors:
``traced(device)`` names the device those tensors claim, ``cuda`` with no
card included, and ``resolve_device`` takes it only under an active
``FakeTensorMode``.  A build of PyTorch without CUDA cannot take fake
CUDA tensors through the autograd engine or Python indexing (both ask
for CUDA's device guard): there ``trace_device`` puts them on the CPU
and ``route_as`` makes ``device_type``, which the kernels' dispatch
reads, name CUDA for them, so the trace takes the card's paths.
``host_value`` is the one place where a host read of a tensor decides a
branch or a loop's stop; on a fake tensor, which has no value, it
answers what the caller names (the costlier branch, a loop run on to its
cap), as the reference's cost parser counts a while loop at its static
bound; or, inside ``host_tape(values)``, the reads a real run of the same
program made (``host_tape()`` records them), so that a trace takes the
stops that run took (``repro_torch.verify`` traces the program as it runs
on its harness inputs).
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

# the host reads a fake trace replays, or a real run records (None: none)
_TAPE: contextvars.ContextVar = contextvars.ContextVar("host_tape",
                                                      default=None)
# the device type a dry trace's fake tensors route as (None: their own)
_ROUTE_AS: contextvars.ContextVar = contextvars.ContextVar("route_as",
                                                          default=None)


class traced(str):
    """A device named for a fake trace (``traced("cuda")``): the fake
    tensors' device, which needs no card; ``resolve_device`` takes it only
    under an active ``FakeTensorMode``."""


def tracing() -> bool:
    """Whether a ``FakeTensorMode`` is active."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return isinstance(t, torch.Tensor) and _is_fake(t)


def trace_device(device) -> tuple[torch.device, str | None]:
    """(the device a dry trace makes its fake tensors on, the device type
    they route as, or None) for the device ``device`` names: itself; but
    on a build without CUDA a CUDA device's tensors lie on the CPU and
    route as CUDA (``route_as``)."""
    dev = torch.device(str(device))
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("cpu"), "cuda"
    return dev, None


@contextlib.contextmanager
def route_as(device_type: str | None):
    """For a ``with`` block, fake tensors take the paths of
    ``device_type`` (None: their own device's)."""
    token = _ROUTE_AS.set(device_type)
    try:
        yield
    finally:
        _ROUTE_AS.reset(token)


def device_type(t) -> str:
    """The device type whose path ``t`` takes: its device's, or for a
    fake tensor under ``route_as``, the type it routes as."""
    routed = _ROUTE_AS.get()
    if routed is not None and is_fake(t):
        return routed
    return t.device.type


class _Tape:
    def __init__(self, values):
        self.replay = values is not None
        self.values = list(values) if self.replay else []
        self.pos = 0


@contextlib.contextmanager
def host_tape(values=None):
    """For a ``with`` block: with no ``values``, record every host read
    of a real tensor (``host_value``) into the list it yields; with
    ``values``, a read of a fake tensor takes the next of them (and,
    once they run out, its ``traced`` value)."""
    tape = _Tape(values)
    token = _TAPE.set(tape)
    try:
        yield tape.values
    finally:
        _TAPE.reset(token)


def host_value(t, *, traced):
    """The Python value of the 0-d tensor ``t``, read on the host to
    decide a branch or a loop's stop; ``traced`` where ``t`` is a fake
    tensor (a dry trace), which has no value, unless a ``host_tape``
    replays a real run's reads."""
    tape = _TAPE.get()
    if is_fake(t):
        if tape is not None and tape.replay and tape.pos < len(tape.values):
            tape.pos += 1
            return tape.values[tape.pos - 1]
        return traced
    value = t.item()
    if tape is not None and not tape.replay:
        tape.values.append(value)
    return value


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but missing.  A
    ``traced`` device is taken as it is, and only under a fake mode."""
    if isinstance(device, traced):
        if not tracing():
            raise RuntimeError(f"the traced device {str(device)!r} names "
                               "fake tensors: use it under FakeTensorMode")
        return torch.device(str(device))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_precision() -> None:
    """Full-f32 matmuls, and bf16 matmuls that reduce in float32 (cuBLAS may
    otherwise split the reduction in bf16); set when an entry point or a
    step runs, never at import."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the reference is "
            "float32 throughout and TF32 matmuls would drift from it")


def expandable_segments() -> None:
    """Let the CUDA caching allocator grow its segments in place.  At LM
    width a round holds (m, P) and (k, P) float32 blocks of tens of GB,
    which a cache fragmented by earlier allocations may otherwise refuse.
    CUDA reads the setting when it first initialises, so it is set only
    while CUDA is not yet initialised (a caller's own setting wins)."""
    if not torch.cuda.is_initialized():
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")


def enter(device=None) -> torch.device:
    """Entry-point preamble: ``set_precision``, then the resolved device."""
    set_precision()
    return resolve_device(device)
