"""Sharded bipartite mapper attention (shard_map, model axis).

The encoder/decoder mappers cross two differently-ordered node sets (data
grid ↔ hidden mesh), so under a ``model`` mesh axis their gathers cannot stay
shard-local the way the processor's halo exchange does. The reference solves
this by sharding edges and head-all-to-all-ing Q/K/V
(``/root/reference/src/anemoi/models/layers/block.py:366-414``); GSPMD-ing
that dataflow trips involuntary full rematerializations (full node-tensor
all-gathers) on the mapper's fused-projection splits.

The answer here keeps everything destination-sharded:

- destination rows are contiguously sharded; each shard holds a precomputed
  (dst_per_shard, cap) slot table (``graphs.partition.mapper_shard_tables``);
- the only collective is ONE tiled all-gather of the *narrow* source rows
  (raw inputs ~20 wide for the encoder, C-wide hidden rows for the decoder —
  never the 2×(H·D) k/v tensors);
- k/v are projected shard-locally on the gathered slot rows (the
  narrow-gather trade: fewer gather bytes for more matmul FLOPs), the per-destination
  softmax completes within the shard, and every adjoint is a precomputed
  position-table take — forward and backward are scatter-free.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from anemoi_models_tpu.graphs.partition import MapperShardTables
from anemoi_models_tpu.ops.dense_graph import padded_take_rows, unique_take_rows

__all__ = ["sharded_mapper_edge_attention"]


def sharded_mapper_edge_attention(
    mesh: Mesh,
    st: MapperShardTables,
    query: jnp.ndarray,  # (B, Nd, H, D) destination queries (true rows)
    src: jnp.ndarray,  # (B, Ns, A) narrow source rows
    edge_attr: jnp.ndarray,  # (B, E, A_e) raw edge attributes
    edge_transform: Callable = None,  # (..., A_e) -> (..., H, D)
    src_transform: Callable = None,  # (..., cap, A) -> ((..., cap, H, D) k, v)
    axis: str = "model",
    num_chunks: int = 1,
    commute=None,  # ops.dense_graph.CommutedProj — zero-slot-matmul dataflow
    src_feat_transform: Callable = None,  # commute: per-row prefix (..., A) -> (..., C)
) -> jnp.ndarray:
    """Per-edge bipartite attention, destination-sharded. Returns
    (B, Nd, H, D). The transforms may close over (traced) parameters — they
    enter the shard_map region as replicated captures and their gradients
    psum correctly across shards.

    ``num_chunks`` > 1 processes destination rows in chunks (each under
    ``jax.checkpoint``): the wide (H·D) k/v/edge slot slabs — the dominant
    live tensors at production scale — become
    per-chunk transients, while the *narrow* gathered rows stay whole-shard
    so the scatter-free source adjoint needs no per-chunk tables. Chunking
    splits complete destination rows, so softmax semantics are unchanged.

    With ``commute`` (a :class:`~anemoi_models_tpu.ops.dense_graph.CommutedProj`)
    the k/v/edge projections move across the gather onto the query/output
    sides (see ``ops.dense_graph.commuted_edge_attention`` for the identity):
    the 2×(H·D) k/v slot slabs never exist — per chunk the only wide slot
    tensor is the single feature slab — and the per-slot matmuls (at O1280
    ~100 TFLOP/layer) are replaced by per-node ones."""
    b, n_dst, h, d = query.shape
    s_n, nps, cap = st.src_ids.shape
    nsps = st.src_per_shard
    scale = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32))

    qp = jnp.pad(query, ((0, 0), (0, s_n * nps - n_dst), (0, 0), (0, 0)))
    sp = jnp.pad(src, ((0, 0), (0, s_n * nsps - src.shape[1]), (0, 0)))

    # per-slot edge rows, gathered once OUTSIDE shard_map (each edge fills
    # exactly one slot, so the adjoint is a single masked position-take)
    e_slots = unique_take_rows(
        edge_attr, jnp.asarray(st.slot_edge_gids), jnp.asarray(st.pos_of_edge)
    ).reshape(b, s_n, nps, cap, edge_attr.shape[-1])

    def _softmax(logits, m_c):
        logits = jnp.where(m_c[..., None], logits, -jnp.inf)
        m = jnp.max(logits, axis=-2, keepdims=True)
        m = jnp.where(jnp.isfinite(m), m, 0.0)  # edge-less (padding) rows
        w = jnp.exp(logits - m)
        w = jnp.where(m_c[..., None], w, 0.0)
        denom = jnp.maximum(w.sum(axis=-2, keepdims=True), 1e-16)
        return w / denom

    def rows_attention(q_c, g_c, e_c, m_c):
        """Complete-row slot attention on a chunk of destination rows."""
        if commute is not None:
            dt = q_c.dtype
            f_n = g_c if src_feat_transform is None else src_feat_transform(g_c)
            qk = jnp.einsum(
                "bnhd,chd->bnhc", q_c, commute.w_k, preferred_element_type=jnp.float32
            ).astype(dt)
            qe = jnp.einsum(
                "bnhd,ahd->bnha", q_c, commute.w_e, preferred_element_type=jnp.float32
            ).astype(dt)
            logits = (
                jnp.einsum("bnhc,bnkc->bnkh", qk, f_n, preferred_element_type=jnp.float32)
                + jnp.einsum("bnha,bnka->bnkh", qe, e_c, preferred_element_type=jnp.float32)
            ) * scale
            alpha = _softmax(logits, m_c).astype(dt)
            s = jnp.einsum(
                "bnkh,bnkc->bnhc", alpha, f_n, preferred_element_type=jnp.float32
            ).astype(dt)
            se = jnp.einsum(
                "bnkh,bnka->bnha", alpha, e_c, preferred_element_type=jnp.float32
            ).astype(dt)
            out = jnp.einsum(
                "bnhc,chd->bnhd", s, commute.w_v, preferred_element_type=jnp.float32
            ).astype(dt) + jnp.einsum(
                "bnha,ahd->bnhd", se, commute.w_e, preferred_element_type=jnp.float32
            ).astype(dt)
            if commute.b_out is not None:
                has_edge = m_c.any(axis=-1)  # (rows,)
                out = out + has_edge[:, None, None] * commute.b_out.astype(dt)
            return out  # (B, rows, H, D)
        k_n, v_n = src_transform(g_c)  # each (B, rows, cap, H, D)
        e_n = edge_transform(e_c)
        k_n = k_n + e_n
        v_n = v_n + e_n
        logits = (
            jnp.einsum("bnhd,bnkhd->bnkh", q_c, k_n, preferred_element_type=jnp.float32)
            * scale
        )
        alpha = _softmax(logits, m_c).astype(v_n.dtype)
        return (v_n * alpha[..., None]).sum(axis=-3)  # (B, rows, H, D)

    def local(q_blk, s_blk, e_blk, ids_blk, mask_blk, ttab_blk, tmask_blk):
        # q (B, nps, H, D); s (B, nsps, A); e (B, 1, nps, cap, Ae);
        # ids/mask (1, nps, cap); ttab/tmask (1, S*nsps, M)
        src_full = jax.lax.all_gather(s_blk, axis, axis=1, tiled=True)
        ids = ids_blk[0].reshape(-1)
        g_n = padded_take_rows(src_full, ids, ttab_blk[0], tmask_blk[0])
        g_n = g_n.reshape(b, nps, cap, src_full.shape[-1])
        e_raw = e_blk[:, 0]
        m_blk = mask_blk[0]
        if num_chunks <= 1:
            return rows_attention(q_blk, g_n, e_raw, m_blk)
        bounds = [round(i * nps / num_chunks) for i in range(num_chunks + 1)]
        outs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            outs.append(
                jax.checkpoint(rows_attention)(
                    q_blk[:, lo:hi], g_n[:, lo:hi], e_raw[:, lo:hi], m_blk[lo:hi]
                )
            )
        return jnp.concatenate(outs, axis=1)

    out = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, axis, None, None),
            P(None, axis, None),
            P(None, axis, None, None, None),
            P(axis, None, None),
            P(axis, None, None),
            P(axis, None, None),
            P(axis, None, None),
        ),
        out_specs=P(None, axis, None, None),
    )(
        qp,
        sp,
        e_slots,
        jnp.asarray(st.src_ids),
        jnp.asarray(st.mask),
        jnp.asarray(st.t_src_tab),
        jnp.asarray(st.t_src_mask),
    )
    return out[:, :n_dst]
