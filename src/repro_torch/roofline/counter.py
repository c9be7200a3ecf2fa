"""The dry run's cost counter (counterpart of ``repro.roofline.hlo_parser``).

The reference reads one device's costs from the partitioned HLO of its
SPMD program.  The port has no SPMD compiler: each rank runs its own
program, so the dry run traces one rank's step on fake tensors under
``Counter``, a ``TorchDispatchMode`` that sees every op the step runs and
gathers three counts:

* ``dot_flops``: the matmul and attention work, by ``FlopCounterMode``'s
  formulas (its registry, ``flop_registry``) and the custom ops' own (``repro_torch::flash_attention``
  counts 4·B·H·hd a live (q, k) pair; ``repro_torch::gmom_round`` none, as
  the reference's dot count gives a custom call none);
* ``bytes_accessed``: each op's tensor operands read once and its results
  written once; views and the allocations of ``empty`` are left out, as
  the reference's parser leaves out its aliasing ops;
* ``peak_bytes``: the high-water mark of the live storage on the traced
  device, the step's inputs (``track``) included: the counterpart of the
  reference's arguments + temps + outputs - aliases.  A custom op's
  scratch beyond its outputs (``SCRATCH``) counts while the op runs.

Loops whose stop depends on the data run to their cap under a fake trace
(``_device.host_value``), as the reference's parser takes a while loop's
static bound.  The per-op log (``ops``) is the counterpart of the HLO
text: calls, bytes and FLOPs by op name.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# metadata queries, which read no tensor data
_METADATA = {torch.ops.prim.device.default}

# allocations whose result holds nothing yet: no bytes written; and an
# abstract mesh's collective (``models.meshctx``), which the mesh's stats
# count and which moves no bytes of the device
_NO_WRITE = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "mesh_transfer"}


def _round_scratch(args) -> int:
    from repro_torch.kernels.geomed import round as round_kernel
    g, bsz = args[0], args[3]
    return round_kernel.scratch_bytes(bsz.shape[0], g.shape[1])


# custom op -> (its args -> bytes of scratch beyond its outputs)
SCRATCH = {"repro_torch::gmom_round": _round_scratch}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(args):
    """The tensors among an op's arguments or results (a list of tensors
    counts its members)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


class Counter(TorchDispatchMode):
    """Counts what the ops run under it do (see the module docstring):
    ``dot_flops``, ``bytes_accessed``, ``peak_bytes`` on ``device`` (a
    device type, or None: every device), and ``ops``, name -> [calls,
    bytes]."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device
        self.dot_flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak_bytes = 0
        self.ops = {}
        self._seen = weakref.WeakSet()
        self._funcs = {}

    # -- the live storage -------------------------------------------------
    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _hold(self, t) -> None:
        if self.device is not None and t.device.type != self.device:
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        nbytes = st.nbytes()
        self.live += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, nbytes)

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (the step's inputs) as live from
        now on -> their bytes."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return self.live - before

    def _info(self, func):
        """(name, moves no bytes, flop formula, scratch, log entry) of an
        op, looked up once."""
        info = self._funcs.get(func)
        if info is None:
            name = func._schema.name
            info = self._funcs[func] = (
                name, func.is_view or func.overloadpacket.__name__
                in _NO_WRITE, flop_registry.get(func.overloadpacket),
                SCRATCH.get(name), self.ops.setdefault(name, [0, 0, 0]))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        name, view, formula, scratch, entry = self._info(func)
        extra = scratch(args) if scratch is not None else 0
        if extra:
            self.live += extra
            self.peak_bytes = max(self.peak_bytes, self.live)
        out = func(*args, **kwargs)
        self.live -= extra
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        self.dot_flops += flops
        moved = 0
        if not view:
            results = out if isinstance(out, (list, tuple)) else (out,)
            for t in _tensors(args):
                moved += _nbytes(t)
            for t in _tensors(kwargs.values()):
                moved += _nbytes(t)
            for t in _tensors(results):
                moved += _nbytes(t)
                self._hold(t)
        self.bytes_accessed += moved
        entry[0] += 1
        entry[1] += moved
        entry[2] += flops
        return out

    def op_log(self) -> dict:
        """name -> {"calls", "bytes", "flops"}, by name."""
        return {name: dict(zip(("calls", "bytes", "flops"), v))
                for name, v in sorted(self.ops.items())}
