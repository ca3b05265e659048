"""Attention implementation equivalence: the blockwise GPU route
(``impl="chunked"``) against the plain reference, and the choice of route
per platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.ops.attention import (
    blockwise_attention,
    dot_product_attention,
    resolve_attention_impl,
)


def qkv(n=96, d=16, h=2, b=1, seed=0, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    return tuple(jnp.asarray(rng.randn(b, h, n, d), dtype) for _ in range(3))


@pytest.mark.parametrize("window", [None, 8, 32])
def test_blockwise_matches_reference(window):
    q, k, v = qkv()
    ref = dot_product_attention(q, k, v, window_size=window, impl="reference")
    blk = blockwise_attention(q, k, v, window_size=window, block_size=32)
    np.testing.assert_allclose(np.asarray(blk), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 16])
def test_blockwise_causal(window):
    q, k, v = qkv(n=40)
    ref = dot_product_attention(q, k, v, window_size=window, is_causal=True, impl="reference")
    blk = blockwise_attention(q, k, v, window_size=window, is_causal=True, block_size=16)
    np.testing.assert_allclose(np.asarray(blk), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 8])
def test_blockwise_grad_matches_reference(window):
    q, k, v = qkv(n=48, d=8)

    def loss(fn):
        return lambda q_: jnp.sum(fn(q_) ** 2)

    ref_fn = loss(lambda q_: dot_product_attention(q_, k, v, window_size=window, impl="reference"))
    blk_fn = loss(lambda q_: blockwise_attention(q_, k, v, window_size=window, block_size=16))
    np.testing.assert_allclose(
        np.asarray(jax.grad(blk_fn)(q)), np.asarray(jax.grad(ref_fn)(q)), atol=1e-4, rtol=1e-3
    )


# bf16 inputs: both routes accumulate the softmax in float32 but round the
# probabilities to bf16 before the value product, so they agree to bf16's
# ~3 significant digits rather than bit for bit
_TOL = {jnp.float32: dict(atol=3e-5, rtol=1e-4), jnp.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("window", [None, 5, 24])
@pytest.mark.parametrize("n", [37, 70])  # neither a multiple of the 16-row block
def test_chunked_route_matches_reference(n, window, causal, dtype):
    """``impl="chunked"`` (the GPU route) against the reference over window,
    causal mask, dtype and a ragged last block."""
    q, k, v = qkv(n=n, d=8, seed=n, dtype=dtype)
    ref = dot_product_attention(q, k, v, window_size=window, is_causal=causal, impl="reference")
    out = blockwise_attention(q, k, v, window_size=window, is_causal=causal, block_size=16)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), **_TOL[dtype]
    )


@pytest.mark.parametrize("window", [None, 6])
def test_chunked_gradient_rule_matches_reference(window):
    """d/dq, d/dk and d/dv of the blockwise route equal the reference's."""
    q, k, v = qkv(n=45, d=8, seed=3)

    def loss(fn):
        return lambda *t: jnp.sum(fn(*t) * jnp.cos(jnp.arange(8.0)))

    ref = jax.grad(
        loss(lambda *t: dot_product_attention(*t, window_size=window, impl="reference")),
        argnums=(0, 1, 2),
    )(q, k, v)
    blk = jax.grad(
        loss(lambda *t: blockwise_attention(*t, window_size=window, block_size=16)),
        argnums=(0, 1, 2),
    )(q, k, v)
    for a, b in zip(blk, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize(
    "impl,platform,expected",
    [
        ("auto", "gpu", "chunked"),
        ("auto", "cpu", "reference"),
        ("chunked", "gpu", "chunked"),
        ("chunked", "cpu", "chunked"),
        ("reference", "gpu", "reference"),
        ("reference", "cpu", "reference"),
    ],
)
def test_attention_route_per_platform(impl, platform, expected):
    assert resolve_attention_impl(impl, platform) == expected


@pytest.mark.parametrize("impl,platform", [("auto", "rocm"), ("pallas", "gpu"), ("flash", "cpu")])
def test_attention_route_refuses_unknown(impl, platform):
    with pytest.raises(ValueError):
        resolve_attention_impl(impl, platform)


def test_auto_route_on_this_backend_is_reference():
    """The suite runs on the CPU, where ``auto`` is the plain reference."""
    q, k, v = qkv(n=20)
    out = dot_product_attention(q, k, v, window_size=4)
    ref = dot_product_attention(q, k, v, window_size=4, impl="reference")
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
