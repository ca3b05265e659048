"""Scaled-dot-product attention with optional sliding window.

Replaces the reference's flash-attn CUDA kernel / ATen SDPA fallback
(``layers/attention.py:19-26,92-105``). Two implementations:

- ``reference``: plain jnp einsum attention with an explicit band mask and
  fp32 softmax accumulation — the plain reference, O(N²) memory.
- ``chunked``: :func:`blockwise_attention`, the same math over query blocks
  against their key window only — O(N·w) memory, dropout supported.

``impl="auto"`` picks ``chunked`` on the GPU and ``reference`` on the CPU
(the test suite's platform); any other platform is an error.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["dot_product_attention", "blockwise_attention", "resolve_attention_impl"]

_NEG_INF = -1e30

_AUTO_IMPL = {"gpu": "chunked", "cpu": "reference"}


def resolve_attention_impl(impl: str, platform: Optional[str] = None) -> str:
    """The implementation ``impl`` names on ``platform`` (default: JAX's
    default backend)."""
    if impl != "auto":
        if impl not in ("chunked", "reference"):
            raise ValueError(f"attention impl must be auto, chunked or reference, got {impl!r}")
        return impl
    platform = platform or jax.default_backend()
    if platform not in _AUTO_IMPL:
        raise ValueError(f"no attention route for platform {platform!r} (gpu or cpu)")
    return _AUTO_IMPL[platform]


def _band_mask(n_q: int, n_k: int, window: int) -> jnp.ndarray:
    """Boolean (n_q, n_k) mask, True where |i - j| <= window."""
    qi = jnp.arange(n_q)[:, None]
    kj = jnp.arange(n_k)[None, :]
    return jnp.abs(qi - kj) <= window


def _reference_attention(
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    window_size: Optional[int],
    is_causal: bool,
    dropout_rate: float = 0.0,
    dropout_rng=None,
) -> jnp.ndarray:
    head_dim = query.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(head_dim, dtype=jnp.float32))
    logits = jnp.einsum("...qd,...kd->...qk", query, key, preferred_element_type=jnp.float32)
    logits = logits * scale
    n_q, n_k = logits.shape[-2], logits.shape[-1]
    neg = jnp.asarray(_NEG_INF, dtype=logits.dtype)
    if window_size is not None:
        logits = jnp.where(_band_mask(n_q, n_k, window_size), logits, neg)
    if is_causal:
        causal = jnp.tril(jnp.ones((n_q, n_k), dtype=bool))
        logits = jnp.where(causal, logits, neg)
    weights = jax.nn.softmax(logits, axis=-1)
    if dropout_rate > 0.0:
        # dropout on the attention *probabilities*, like the reference's
        # SDPA/flash dropout_p (``layers/attention.py:60,99-105``)
        keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout_rate, weights.shape)
        weights = jnp.where(keep, weights / (1.0 - dropout_rate), 0.0)
    return jnp.einsum("...qk,...kd->...qd", weights.astype(value.dtype), value)


def blockwise_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    block_size: int = 512,
    dropout_rate: float = 0.0,
    dropout_rng=None,
) -> jnp.ndarray:
    """Windowed attention over q-blocks with O(N·(blk+2w)) live memory.

    q, k, v are (batch, heads, seq, head_dim); ``window_size`` is the
    half-width w — query i attends keys j with |i - j| <= w. Each query
    block sees one contiguous key slab of width ``blk + 2w`` (fp32 softmax
    accumulation, as the reference path). Optional attention-weight dropout
    is exact per q-block (each block sees its full key window, so dropping
    normalized probabilities needs no cross-block correction).
    """
    b, h, n, d = q.shape
    blk = min(block_size, n)
    npad = -(-n // blk) * blk
    nb = npad // blk
    qp = jnp.pad(q, ((0, 0), (0, 0), (0, npad - n), (0, 0)))
    scale = 1.0 / (d**0.5)

    if window_size is None:
        kwidth = n
    else:
        kwidth = min(blk + 2 * window_size, n)

    def one_block(i):
        qs = jax.lax.dynamic_slice(qp, (0, 0, i * blk, 0), (b, h, blk, d))
        if window_size is None:
            ks, vs, kstart = k, v, 0
        else:
            kstart = jnp.clip(i * blk - window_size, 0, n - kwidth)
            ks = jax.lax.dynamic_slice(k, (0, 0, kstart, 0), (b, h, kwidth, d))
            vs = jax.lax.dynamic_slice(v, (0, 0, kstart, 0), (b, h, kwidth, d))
        s = jnp.einsum("bhqd,bhkd->bhqk", qs, ks, preferred_element_type=jnp.float32) * scale
        qpos = i * blk + jnp.arange(blk)[:, None]
        kpos = kstart + jnp.arange(kwidth)[None, :]
        mask = (qpos < n) & (kpos < n)
        if window_size is not None:
            mask &= jnp.abs(qpos - kpos) <= window_size
        if is_causal:
            mask &= qpos >= kpos
        s = jnp.where(mask, s, _NEG_INF)
        w = jax.nn.softmax(s, axis=-1)
        if dropout_rate > 0.0:
            keep = jax.random.bernoulli(
                jax.random.fold_in(dropout_rng, i), 1.0 - dropout_rate, w.shape
            )
            w = jnp.where(keep, w / (1.0 - dropout_rate), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", w.astype(v.dtype), vs)

    if nb <= 64:
        # unrolled: XLA fuses each block's mask/softmax with its neighbours
        blocks = jnp.stack([one_block(i) for i in range(nb)])
    else:
        blocks = jax.lax.map(one_block, jnp.arange(nb))
    out = jnp.moveaxis(blocks, 0, 2).reshape(b, h, npad, d)
    return out[:, :, :n]


def dot_product_attention(
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_rng=None,
) -> jnp.ndarray:
    """Attention over (..., heads, seq, head_dim) tensors.

    ``window_size``: half-width of the sliding attention window (the
    reference passes flash-attn ``window_size=(w, w)``, i.e. each query
    attends keys within ±w positions).

    ``dropout_rate``/``dropout_rng``: attention-*weight* dropout matching the
    reference's SDPA/flash ``dropout_p``, on both implementations.
    """
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError("attention dropout_rate > 0 requires a dropout_rng")
    if resolve_attention_impl(impl) == "chunked":
        return blockwise_attention(
            query, key, value, window_size=window_size, is_causal=is_causal,
            dropout_rate=dropout_rate, dropout_rng=dropout_rng,
        )
    return _reference_attention(query, key, value, window_size, is_causal, dropout_rate, dropout_rng)
