"""The reference's own mesh decode and short prefill, for
tests/test_torch_mesh_decode.py (run as a script, in a process of its
own: the virtual devices must be set before jax is imported).

    python tests/mesh_decode_reference.py CASES OUT MESH

CASES is a pickle of {case id: case} (the test's decode and prefill
cases: the arch, the config fields in ``overrides``, numpy params,
tokens, the audio memory, a prefill batch); MESH is "2x2" or "1x4".  On
8 virtual CPU devices (``XLA_FLAGS``), with the original threefry, the
script builds the ("data", "model") mesh of MESH over the first 4 with
Auto axes (jax 0.9.0's default axis types fail the embedding gather),
and under it runs, jitted, ``steps.make_serve_step`` with the params in
``sharding.param_shardings`` and the state in
``sharding.decode_state_shardings`` (token t at position t: every step's
logits), and ``steps.make_prefill_step`` on the whole batch.  OUT gets a
pickle of {case id: numpy logits (B, S, V) or hidden states}.
"""

import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_THREEFRY_PARTITIONABLE"] = "0"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402

from repro import configs  # noqa: E402
from repro.launch import sharding, steps  # noqa: E402
from repro.models import meshctx, model  # noqa: E402

SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}


def _decode(case, cfg, params, mesh):
    tokens = np.asarray(case["tokens"], np.int32)
    B, S = tokens.shape
    pspecs = sharding.param_shardings(params, mesh, cfg)
    params = jax.device_put(params, pspecs)
    state = model.init_decode_state(cfg, B, case["max_len"])
    if "memory" in case:
        state["memory"] = jnp.asarray(case["memory"])
    sspecs = sharding.decode_state_shardings(state, mesh, cfg, B)
    state = jax.device_put(state, sspecs)
    rows = NamedSharding(mesh, sharding.serve_batch_spec(mesh, B))
    step = jax.jit(steps.make_serve_step(cfg),
                   in_shardings=(pspecs, sspecs, rows, rows),
                   out_shardings=(None, sspecs))
    out = []
    for t in range(S):
        logits, state = step(
            params, state, jax.device_put(jnp.asarray(tokens[:, t:t + 1]),
                                          rows),
            jax.device_put(jnp.full((B,), t, jnp.int32), rows))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1)


def _prefill(case, cfg, params, mesh):
    params = jax.device_put(params, sharding.param_shardings(params, mesh,
                                                             cfg))
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()
             if k != "labels"}
    return np.asarray(jax.jit(steps.make_prefill_step(cfg))(params, batch))


def main(cases_file, out_file, mesh_name):
    with open(cases_file, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh(SHAPES[mesh_name], ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    out = {}
    with meshctx.set_mesh(mesh):
        for cid, case in cases.items():
            cfg = configs.get_config(case["arch"]).reduced().with_(
                **case.get("overrides", {}))
            params = jax.tree.map(jnp.asarray, case["params"])
            run = _decode if case["kind"] == "decode" else _prefill
            out[cid] = run(case, cfg, params, mesh)
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
