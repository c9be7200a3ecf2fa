"""The port's integer and Bernoulli draws (repro_torch.random.randint,
bernoulli) and its LM token stream (repro_torch.data.tokens.TokenStream)
against the JAX package's, bit for bit, under the non-partitionable
threefry the port mirrors."""

import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenStream as JTokenStream
from repro_torch import random as prng
from repro_torch.data.tokens import TokenStream


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


# (shape, minval, maxval): small and vocabulary-sized spans, spans past
# 2**16 (where the reference's uint32 multiplier wraps to 0), the whole
# int32 range, negative bounds, and maxval <= minval (always minval)
RANDINT_CASES = [((7,), 0, 100), ((3, 5), -50, 50), ((4, 4, 1), 0, 32_000),
                 ((33,), 0, 1 << 16), ((33,), 0, (1 << 16) + 1),
                 ((50,), -3, 70_000), ((17,), 0, 2 ** 31 - 1),
                 ((1000,), -2 ** 31, 2 ** 31 - 1), ((9,), 5, 5),
                 ((9,), 7, 3), ((2, 3), -10, -20)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape,lo,hi", RANDINT_CASES)
def test_randint_bit_equal_to_jax(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if hi <= lo:
        assert (got == lo).all()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shape,p", [((10,), 0.5), ((3, 40), 0.1),
                                     ((5, 2, 7), 0.9), ((64,), 0.0),
                                     ((64,), 1.0)])
def test_bernoulli_bit_equal_to_jax(seed, shape, p):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                           shape))
    got = prng.bernoulli(prng.PRNGKey(seed), p, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_bernoulli_shape_defaults_to_p():
    p = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(3, 4)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(1), p))
    got = prng.bernoulli(prng.PRNGKey(1), torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_stream_bit_equal_to_jax(seed):
    """Tokens and labels equal for 3 steps at a full vocabulary (the Zipf
    draw's f32 power may move by ulps; the integer cast must absorb it)."""
    kw = dict(vocab_size=32_000, seq_len=96, global_batch=16, num_workers=8,
              seed=seed)
    ref, mine = JTokenStream(**kw), TokenStream(**kw, device="cpu")
    for step in (0, 3, 11):
        want, got = ref.batch(step), mine.batch(step)
        for name in ("tokens", "labels"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_token_stream_deterministic_and_shaped():
    s = TokenStream(vocab_size=100, seq_len=16, global_batch=8,
                    num_workers=4, seed=3, device="cpu")
    b1, b2 = s.batch(5), s.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 2, 16)
    assert int(b1["tokens"].max()) < 100 and int(b1["tokens"].min()) >= 0
    assert not torch.equal(b1["tokens"], s.batch(6)["tokens"])
    # labels are next tokens
    assert torch.equal(b1["labels"][..., :-1], b1["tokens"][..., 1:])


def test_token_stream_refuses_uneven_workers_and_wants_the_card(
        monkeypatch):
    with pytest.raises(ValueError, match="divide evenly"):
        TokenStream(vocab_size=10, seq_len=4, global_batch=6, num_workers=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenStream(vocab_size=10, seq_len=4, global_batch=4,
                    num_workers=2).batch(0)
