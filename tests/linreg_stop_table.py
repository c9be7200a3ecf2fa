"""Where the linreg round's Weiszfeld loop stops, in four versions of the
round on the same inputs, on the CPU:

* ``twin``: ``round.linreg_round_blocked`` on the plan the CUDA kernel's
  wrapper makes on an H100 (132 SMs, two round-kernel blocks an SM), so
  the kernel's count bit for bit;
* ``port_fused``: the port's plain ``round.linreg_round_fused``;
* ``jax_kernel``: the JAX package's ``linreg_round_kernel`` in interpret
  mode, or, where it refuses the shape for its VMEM budget, its jnp twin
  ``linreg_round_ref`` (``via`` says which);
* ``jax_fused``: the JAX package's ``linreg_round_fused``.

The JAX functions return no iteration count.  It is read from their
iterates: the loop stopped below the cap exactly when the outputs at
``max_iters = cap`` and ``cap - 1`` are equal, and then at the first ``i``
whose output equals the one at the cap (a binary search).  Inputs come
from numpy seeds (X, y, theta drawn in that order), trim 3, in the chip
check's ``fixed32`` (tol 0, cap 32) and ``early_exit`` (tol 1e-8, cap 64)
modes.  One JSON line per input:

    PYTHONPATH=src python tests/linreg_stop_table.py [seeds, default 0,1,2]

Not a test (pytest does not collect it): the whole table takes about ten
minutes.  ``test_torch_linreg_round.py`` pins four of its twin counts.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.grouping import make_grouping as jax_make_grouping
from repro.kernels.geomed import round as jround
from repro_torch.core.grouping import make_grouping
from repro_torch.kernels.geomed import round as tround

SHAPES = [(12, 16, 300, 6), (20, 16, 400, 10), (50, 1000, 100, 10),
          (50, 1000, 100, 11), (64, 20, 512, 64)]
MODES = {"fixed32": dict(tol=0.0, max_iters=32),
         "early_exit": dict(tol=1e-8, max_iters=64)}
SMS, BLOCKS_PER_SM = 132, 2


def data(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, n, d)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


def jax_count(fn, args, grouping, kw, **extra):
    """Iterations of a JAX round that returns only y, from its iterates."""
    cap = kw["max_iters"]

    def y(i):
        return np.asarray(fn(*args, grouping, **dict(
            kw, max_iters=i, trim_multiplier=3.0, **extra)))

    at_cap = y(cap)
    if not np.array_equal(at_cap, y(cap - 1)):
        return cap
    lo, hi = 1, cap - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(y(mid), at_cap):
            hi = mid
        else:
            lo = mid + 1
    return lo


def main(seeds):
    jax.config.update("jax_threefry_partitionable", False)
    for m, n, d, k in SHAPES:
        for seed in seeds:
            arrays = data(m, n, d, seed)
            jargs = [jnp.asarray(a) for a in arrays]
            targs = [torch.as_tensor(a) for a in arrays]
            plan = dict(n_blocks=tround.persistent_blocks(d, BLOCKS_PER_SM,
                                                          SMS),
                        n_split=tround.onepass_split(m, n, SMS))
            for scheme in ("contiguous", "strided"):
                tgroup = make_grouping(m, k, scheme=scheme)
                jgroup = jax_make_grouping(m, k, scheme=scheme)
                for mode, kw in MODES.items():
                    _, twin = tround.linreg_round_blocked(
                        *targs, tgroup, trim_multiplier=3.0, **plan, **kw)
                    _, fused = tround.linreg_round_fused(
                        *targs, tgroup, trim_multiplier=3.0, **kw)
                    try:
                        jk = jax_count(jround.linreg_round_kernel, jargs,
                                       jgroup, kw, interpret=True)
                        via = "kernel"
                    except ValueError:  # past the kernel's VMEM budget
                        jk = jax_count(jround.linreg_round_ref, jargs,
                                       jgroup, kw)
                        via = "ref"
                    jf = jax_count(jround.linreg_round_fused, jargs, jgroup,
                                   kw)
                    print(json.dumps(dict(
                        shape=[m, n, d, k], seed=seed, scheme=scheme,
                        mode=mode, cap=kw["max_iters"], twin=int(twin),
                        port_fused=int(fused), jax_kernel=jk, via=via,
                        jax_fused=jf)), flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1].split(",")] if len(sys.argv) > 1
         else [0, 1, 2])
