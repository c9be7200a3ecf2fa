"""The flash-attention kernel's tensor-core route on the CPU: its route
function, and its arithmetic written out plainly
(``ref.flash_attention_tiled_ref``: bf16 q and k with f32 products, an
online softmax over kv tiles of BK keys in the kernel's order, P rounded
to bf16 for P V, l summed from the f32 p) against the JAX package.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain version there).  Inputs come from
numpy seeds and are rounded to bf16 once, identically in both frameworks.

Tolerances.  Against the JAX Pallas kernel in interpret mode in bf16:
3e-2, the reference's own (tests/test_kernels.py).  Against the plain
version in f32 on the same bf16 inputs, the bound restated from the
arithmetic, elementwise:

    |d| <= 2**-8 |y| + 2**-8 (P|V|) + 2 * 2e-5

2**-8 |y| is the output's rounding; 2**-8 (P|V|) bounds the rounding of
P, whose relative error is at most 2**-9 (the factor 2 leaves room for l
being summed from the unrounded p); P|V| is the plain version in f32 with
|v| in place of v; 2e-5 is the f32 tolerance.  The JAX kernel keeps P in
f32 and rounds its output once, so it lies inside the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash as jflash
from repro.kernels.attention import ref as jref
from repro_torch.kernels.attention import flash, ref

TOL_BF16, TOL_F32 = 3e-2, 2e-5

# (B, Tq, Tk, H, KV, hd, causal, window): tests/test_kernels.py's grid,
# H2O-Danube3's head (hd 120, cut to 8/2 heads) under its window, ragged;
# then Tq < Tk, hd 256 (BK = 64) non-causal under a window, and one more
# tile of 128 than fits at hd 128
GRID = [(2, 64, 64, 4, 2, 32, True, None),
        (1, 128, 128, 8, 8, 64, True, None),
        (2, 100, 100, 4, 1, 32, True, None),
        (1, 256, 256, 4, 2, 64, True, 64),
        (2, 64, 64, 4, 4, 32, False, None),
        (1, 96, 96, 6, 2, 16, True, 32),
        (1, 150, 150, 8, 2, 120, True, 64)]
WIDER = [(2, 77, 200, 4, 2, 128, True, None),
         (1, 70, 150, 4, 1, 256, False, 50),
         (1, 300, 300, 4, 2, 128, True, 200)]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _qkv(case, seed):
    """(q, k, v) as bf16-representable float32 numpy arrays."""
    B, Tq, Tk, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(
        torch.as_tensor(rng.normal(size=s).astype(np.float32))
        .bfloat16().float().numpy()
        for s in ((B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)))


def _torch_bf16(*xs):
    return tuple(torch.as_tensor(x).bfloat16() for x in xs)


def _f32_and_bound(q, k, v, causal, window):
    """The JAX oracle in f32 on the bf16 inputs, and the restated bound."""
    y32 = np.asarray(jref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, sliding_window=window))
    pv = np.asarray(jref.flash_attention_ref(
        *map(jnp.asarray, (q, k, np.abs(v))), causal=causal,
        sliding_window=window))
    return y32, 2.0 ** -8 * np.abs(y32) + 2.0 ** -8 * pv + 2 * TOL_F32


def _twin(q, k, v, causal, window, **kw):
    out = ref.flash_attention_tiled_ref(*_torch_bf16(q, k, v), causal=causal,
                                        sliding_window=window, **kw)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("case", GRID, ids=str)
def test_twin_matches_jax_flash_kernel(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, case[1] * case[5])
    block = 32 if case[1] <= 100 else 64
    want = np.asarray(jflash.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        sliding_window=window, block_q=block, block_kv=block,
        interpret=True), np.float32)
    got = _twin(q, k, v, causal, window)
    np.testing.assert_allclose(got, want, atol=TOL_BF16, rtol=TOL_BF16)
    _, allowed = _f32_and_bound(q, k, v, causal, window)
    assert (np.abs(got - want) <= allowed).all()


@pytest.mark.parametrize("case", GRID + WIDER, ids=str)
def test_twin_within_the_restated_bound_of_the_f32_oracle(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, case[1] + case[5])
    y32, allowed = _f32_and_bound(q, k, v, causal, window)
    got = _twin(q, k, v, causal, window)
    assert (np.abs(got - y32) <= allowed).all()
    # the plain bf16 path (probabilities in bf16, the reference's einsums)
    plain = ref.flash_attention_ref(*_torch_bf16(q, k, v), causal=causal,
                                    sliding_window=window)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=TOL_BF16,
                               rtol=TOL_BF16)


@pytest.mark.parametrize("block_k", [16, 64, 128])
def test_twin_does_not_depend_on_the_tile_beyond_rounding(block_k):
    """A row whose first tiles lie wholly outside its window adds junk
    (p = 1 at the sentinel) that the first live tile wipes: every tile
    size lands within the bound, with the window live."""
    case = (1, 200, 200, 4, 2, 64, True, 40)
    q, k, v = _qkv(case, 9)
    y32, allowed = _f32_and_bound(q, k, v, True, 40)
    got = _twin(q, k, v, True, 40, block_k=block_k)
    assert np.isfinite(got).all()
    assert (np.abs(got - y32) <= allowed).all()


def test_restated_bound_fails_the_no_window_fault():
    """The kernel's arithmetic with the window dropped, against the f32
    oracle with the window: the restated bound must fail it."""
    case = (1, 256, 256, 4, 2, 64, True, 64)
    q, k, v = _qkv(case, 3)
    y32, allowed = _f32_and_bound(q, k, v, True, 64)
    fault = _twin(q, k, v, True, None)
    assert not (np.abs(fault - y32) <= allowed).all()
    assert float((np.abs(fault - y32) / allowed).max()) > 2.0


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 8, "tensor_core"), (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 120, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.bfloat16, 20, "cuda_core"), (torch.bfloat16, 1, "cuda_core"),
    (torch.bfloat16, 250, "cuda_core"), (torch.float32, 120, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core"),
    (torch.float32, 20, "cuda_core")])
def test_route_by_type_and_width(dtype, hd, want):
    assert flash.route(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd", [
    (torch.float64, 64), (torch.float16, 64), (torch.bfloat16, 0),
    (torch.bfloat16, 264), (torch.float32, 272), (torch.int32, 64)])
def test_route_refuses_what_no_kernel_takes(dtype, hd):
    with pytest.raises(ValueError, match="no route takes"):
        flash.route(dtype, hd)


def test_counts_by_route_start_at_zero():
    flash.reset_launches()
    assert flash.flash_attention.launches == 0
    assert flash.flash_attention.route_launches == {"cuda_core": 0,
                                                    "tensor_core": 0}
