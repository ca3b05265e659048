"""Segment ops: the replacement for torch_geometric scatter/softmax.

The reference's hot graph ops are ``scatter(..., reduce="sum")``
(``layers/conv.py:74``) and per-destination segment ``softmax``
(``layers/conv.py:139``), both CUDA kernels from torch_geometric. Here they are
expressed over **CSR-sorted** edge arrays (sorted by destination at graph
build time, ``graphs/container.py``) so XLA can lower them to efficient sorted
segment reductions. This is the plain reference the degree-bucketed
gathers of ``ops/dense_graph.py`` are tested against.

All ops are batched: ``data`` has shape (batch, E, ...) and ``segment_ids``
(E,) shared across the batch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["segment_sum", "segment_max", "segment_softmax", "gather_nodes"]


def gather_nodes(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather node features per edge: x (B, N, C), idx (E,) -> (B, E, C)."""
    return jnp.take(x, idx, axis=-2)


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Sum ``data`` (..., E, C) into segments (..., num_segments, C)."""
    op = partial(
        jax.ops.segment_sum,
        segment_ids=segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )
    for _ in range(data.ndim - 2):
        op = jax.vmap(op)
    return op(data)


def segment_max(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Max over segments; empty segments get -inf."""
    op = partial(
        jax.ops.segment_max,
        segment_ids=segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )
    for _ in range(data.ndim - 2):
        op = jax.vmap(op)
    return op(data)


def segment_softmax(
    scores: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Numerically-stable softmax over edges sharing a destination node.

    ``scores``: (..., E, H) per-edge/per-head logits. Accumulates in fp32
    regardless of input dtype (bf16-safe), matching the fp32-softmax
    discipline required for rollout stability.
    """
    dtype = scores.dtype
    scores32 = scores.astype(jnp.float32)
    seg_max = segment_max(scores32, segment_ids, num_segments, indices_are_sorted)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = scores32 - jnp.take(seg_max, segment_ids, axis=-2)
    exp = jnp.exp(shifted)
    seg_sum = segment_sum(exp, segment_ids, num_segments, indices_are_sorted)
    denom = jnp.take(seg_sum, segment_ids, axis=-2)
    return (exp / jnp.maximum(denom, 1e-16)).astype(dtype)
