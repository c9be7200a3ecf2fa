"""Shared pieces of the port's model-family parity tests
(tests/test_torch_audio.py, test_torch_audio_train.py,
test_torch_vlm.py; test_torch_examples.py takes the thread fixture): the
JAX package's threefry setting, one torch thread a module, numpy inputs
from seeds, the reference's params handed across, and the tolerance
check against max|y|."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs, convert

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for a module's tests, restored after: the suite
    runs in 6 xdist workers on 8 cores, where a worker's torch pool of 8
    threads waits on its own descheduled threads at every parallel op (a
    launch/train.py test of 2 s took 178 s beside six busy processes)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _crossed(jtree):
    """The reference's params -> numpy -> the port's, on the CPU."""
    return convert._tree(jax.tree.map(np.asarray, jtree), "cpu")


def _rows(metrics):
    """Stacked per-round metrics -> a trace for ``compare_traces``."""
    keys = sorted(metrics)
    cols = {k: np.atleast_1d(np.asarray(metrics[k])) for k in keys}
    return {"history": [{k: float(cols[k][i]) for k in keys}
                        for i in range(len(cols[keys[0]]))]}


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def reduced_models(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, the same params in the port) of
    ``arch``'s reduced config, under the original threefry."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        jcfg = jconfigs.get_config(arch).reduced().with_(**kw)
        cfg = configs.get_config(arch).reduced().with_(**kw)
        jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
        return jcfg, cfg, jp, convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), "cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", old)
