"""Full GNN message passing under 1-hop halo exchange (shard_map).

Completes the multi-chip GNN story of ``parallel/halo.py``: not just the
aggregation but the whole reference GraphConv body — message
``mlp(cat[x_i, x_j, e]) + e`` then scatter-sum (reference
``layers/conv.py:27-76``) — computed shard-locally on halo-extended features,
with parameters passed replicated into the shard_map region. Communication
per layer is one boundary-pool all-gather of O(boundary) payload, versus the
reference's full-node all-gather (``layers/block.py:203``).

Parameters are an explicit pytree (functional style) so this composes with
any training loop; ``graph_conv_params``/``apply_edge_mlp`` mirror the MLP
layout of ``layers/mlp.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from anemoi_models_tpu.graphs.partition import HaloPartition
from anemoi_models_tpu.layers.utils import get_activation
from anemoi_models_tpu.ops.segment import segment_sum
from anemoi_models_tpu.parallel.halo import pad_nodes, unpad_nodes

__all__ = [
    "graph_conv_params",
    "halo_graph_conv",
    "halo_graph_transformer_conv",
    "shard_edge_values",
]


def graph_conv_params(
    rng: jax.Array, in_channels: int, out_channels: int, hidden: Optional[int] = None
) -> dict:
    """Edge-MLP params: Linear(3C -> H) -> act -> Linear(H -> H) -> act ->
    Linear(H -> C) (the reference GraphConv edge MLP shape)."""
    hidden = hidden or out_channels
    k1, k2, k3 = jax.random.split(rng, 3)
    init = jax.nn.initializers.lecun_normal()
    return {
        "w1": init(k1, (3 * in_channels, hidden)),
        "b1": jnp.zeros(hidden),
        "w2": init(k2, (hidden, hidden)),
        "b2": jnp.zeros(hidden),
        "w3": init(k3, (hidden, out_channels)),
        "b3": jnp.zeros(out_channels),
    }


def apply_edge_mlp(params: dict, x: jnp.ndarray, activation: str = "SiLU") -> jnp.ndarray:
    """Dense-act-Dense-act-Dense[-LayerNorm], GraphConv's edge-MLP layout.

    The final fp32-stat LayerNorm (AutocastLayerNorm semantics) applies when
    ``ln_s``/``ln_b`` are present — matching the MLP(layer_norm=True) the
    GNNProcessor blocks use, so the halo flavor is a numerical drop-in.
    """
    act = get_activation(activation)
    dt = x.dtype
    x = act(x @ params["w1"] + params["b1"])
    x = act(x @ params["w2"] + params["b2"])
    x = x @ params["w3"] + params["b3"]
    if "ln_s" in params:
        xf = x.astype(jnp.float32)
        mu = xf.mean(-1, keepdims=True)
        var = xf.var(-1, keepdims=True)
        x = ((xf - mu) * jax.lax.rsqrt(var + 1e-6) * params["ln_s"] + params["ln_b"]).astype(dt)
    return x


def halo_graph_conv(
    mesh: Mesh,
    part: HaloPartition,
    params: dict,
    x: jnp.ndarray,
    edge_attr_sharded: jnp.ndarray,
    activation: str = "SiLU",
    axis: str = "model",
    apply_fn: Optional[Callable] = None,
    tables=None,  # graphs.partition.HaloGNNTables -> scatter-free path
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One GraphConv aggregation under halo exchange.

    - ``x``: (batch, num_nodes, C) node features (un-padded; padded inside).
    - ``edge_attr_sharded``: per-shard edge features in the same order as
      ``part.local_edges`` — (num_shards, E_pad, C), or batch-carrying
      (num_shards, batch, E_pad, C) as produced by a previous layer.
    Returns ``(agg, new_edges)``: (batch, num_nodes, C) aggregated messages
    (the conv output before the node MLP/residual) and the updated
    shard-local edge features (num_shards, batch, E_pad, C) to thread into
    the next layer — matching GraphConv's ``edges_new`` threading (reference
    ``layers/block.py:205-221``) without ever gathering edges globally.

    ``apply_fn(params, cat) -> msg`` overrides the edge-MLP body (default
    :func:`apply_edge_mlp`); pass ``layers.mlp.apply_mlp_params`` bound to
    an ``MLP`` param tree to run a standard ``GraphConv``'s own MLP
    shard-locally (identical param layout to the single-device path).

    With ``tables`` (``graphs.partition.HaloGNNTables``), every gather and
    the sum-aggregation run over static padded layouts with take-only
    adjoints — no HLO scatter in forward or backward (the default path uses
    segment ops).
    """
    apply_fn = apply_fn or (lambda p, cat: apply_edge_mlp(p, cat, activation))
    from anemoi_models_tpu.graphs.partition import HaloBucketedTables

    bc = jnp.asarray(part.boundary_contrib)
    hs = jnp.asarray(part.halo_select)
    hm = jnp.asarray(part.halo_mask)
    le = jnp.asarray(part.local_edges)
    em = jnp.asarray(part.edge_mask)
    x_pad = pad_nodes(x, part)
    batched_edges = edge_attr_sharded.ndim == 4
    bucketed = isinstance(tables, HaloBucketedTables)
    n_dst_buckets = len(tables.dst_buckets) if bucketed else 0
    tab_arrays = ()
    if bucketed:
        # flat order: exchange inverses, position ids, reassembles, then the
        # per-bucket (pos_tab, mask) pairs — dst buckets first
        tab_arrays = tuple(
            jnp.asarray(a)
            for a in (*tables.t_contrib, *tables.t_halo,
                      tables.pos_dst, tables.pos_src,
                      tables.dst_reassemble, tables.src_reassemble,
                      *(a for pair in tables.dst_buckets for a in pair),
                      *(a for pair in tables.src_buckets for a in pair))
        )
    elif tables is not None:
        tab_arrays = tuple(
            jnp.asarray(a)
            for a in (tables.dst_tab, tables.dst_mask, tables.dst_inv,
                      tables.src_tab, tables.src_mask,
                      *tables.t_contrib, *tables.t_halo)
        )

    def local(x_blk, bc_blk, hs_blk, hm_blk, le_blk, em_blk, e_blk, p, *tabs):
        from anemoi_models_tpu.ops.dense_graph import (
            bucketed_position_sum,
            padded_take,
            position_gather,
            table_take,
        )

        if tabs:
            off = 0 if bucketed else 5
            tc_t, tc_m, th_t, th_m = (t[0] for t in tabs[off : off + 4])
            contrib = jax.vmap(lambda xb: padded_take(xb, bc_blk[0], tc_t, tc_m))(x_blk)
        else:
            contrib = jnp.take(x_blk, bc_blk[0], axis=1)
        pool = jax.lax.all_gather(contrib, axis, axis=1, tiled=True)
        if tabs:
            halo = jax.vmap(lambda pb: padded_take(pb, hs_blk[0], th_t, th_m))(pool)
        else:
            halo = jnp.take(pool, hs_blk[0], axis=1)
        halo = halo * hm_blk[0][None, :, None].astype(x_blk.dtype)
        x_ext = jnp.concatenate([x_blk, halo], axis=1)

        edges = le_blk[0]
        if bucketed:
            pos_dst, pos_src, dst_re, src_re = (t[0] for t in tabs[4:8])
            pairs = [t[0] for t in tabs[8:]]
            db = tuple(zip(pairs[0 : 2 * n_dst_buckets : 2], pairs[1 : 2 * n_dst_buckets : 2]))
            sb = tuple(zip(pairs[2 * n_dst_buckets :: 2], pairs[2 * n_dst_buckets + 1 :: 2]))
            x_j = position_gather(x_ext, pos_src, sb, src_re)
            x_i = position_gather(x_blk, pos_dst, db, dst_re)
        elif tabs:
            d_tab, d_mask, d_inv, s_tab, s_mask = (t[0] for t in tabs[:5])
            x_j = jax.vmap(lambda xb: padded_take(xb, edges[:, 0], s_tab, s_mask))(x_ext)
            x_i = jax.vmap(lambda xb: padded_take(xb, edges[:, 1], d_tab, d_mask))(x_blk)
        else:
            x_j = jnp.take(x_ext, edges[:, 0], axis=1)  # source features (B, E_pad, C)
            x_i = jnp.take(x_blk, edges[:, 1], axis=1)  # destination features
        if batched_edges:
            e = e_blk[0]  # (B, E_pad, C)
        else:
            e = jnp.broadcast_to(e_blk[0][None], x_i.shape)
        msg = apply_fn(p, jnp.concatenate([x_i, x_j, e], axis=-1)) + e
        msg = msg * em_blk[0][None, :, None].astype(msg.dtype)
        if bucketed:
            agg = bucketed_position_sum(msg, db, dst_re, pos_dst)
        elif tabs:
            agg = jax.vmap(
                lambda mb: table_take(mb, d_tab, d_mask, d_inv).sum(axis=1)
            )(msg)
        else:
            agg = segment_sum(msg, edges[:, 1], part.nodes_per_shard, indices_are_sorted=False)
        return agg, msg[None]  # msg stays shard-local as next layer's edges

    run = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None, None),
            P(axis, None),
            P(axis, None, None, None) if batched_edges else P(axis, None, None),
            P(),  # params replicated
        ) + tuple(P(axis, *([None] * (a.ndim - 1))) for a in tab_arrays),
        out_specs=(P(None, axis, None), P(axis, None, None, None)),
    )
    out, edges_new = run(x_pad, bc, hs, hm, le, em, edge_attr_sharded, params, *tab_arrays)
    return unpad_nodes(out, part), edges_new


def shard_edge_values(
    values: jnp.ndarray, part: HaloPartition, edge_pos=None
) -> jnp.ndarray:
    """Rearrange global CSR-ordered per-edge values (..., E, C) into the
    per-shard layout matching ``part.local_edges`` (gather by the partition's
    global edge ids; padded slots carry edge 0 and are masked inside the
    kernel). (E, C) input -> (S, E_pad, C); batched (B, E, C) input ->
    (S, B, E_pad, C).

    ``edge_pos`` (E,) — each global edge's flat (S·E_pad) slot, from
    ``HaloGNNTables`` — makes the gather's adjoint a masked position-take
    instead of a scatter (every edge lives in exactly one shard slot)."""
    if edge_pos is not None and values.ndim == 3:
        from anemoi_models_tpu.ops.dense_graph import _masked_pos_take, take_rows

        s, e_pad = part.edge_ids.shape
        e = values.shape[-2]
        flat_ids = np.asarray(part.edge_ids).ravel()

        def one(vb):  # (E, C) -> (S, E_pad, C)
            def adj(g):  # (S*E_pad, C) -> (E, C)
                return _masked_pos_take(g, edge_pos, e, axis=-2)

            return take_rows(vb, flat_ids, 0, adj).reshape(s, e_pad, -1)

        return jnp.moveaxis(jax.vmap(one)(values), 1, 0)  # (S, B, E_pad, C)
    ids = jnp.asarray(part.edge_ids)  # (S, E_pad)
    gathered = jnp.take(values, ids, axis=-2)  # (..., S, E_pad, C)
    if values.ndim == 2:
        return gathered
    return jnp.moveaxis(gathered, -3, 0)


def halo_graph_transformer_conv(
    mesh: Mesh,
    part: HaloPartition,
    query: jnp.ndarray,  # (B, N, H, D) destination-node queries
    key: jnp.ndarray,  # (B, N, H, D)
    value: jnp.ndarray,  # (B, N, H, D)
    a_sharded: jnp.ndarray,  # (S, E_pad, A') raw edge attrs in shard layout
    w_aug: jnp.ndarray,  # (A', H, D) affine edge projection (bias folded)
    axis: str = "model",
) -> jnp.ndarray:
    """Per-edge attention on a self-graph under 1-hop halo exchange.

    The multi-chip answer to the reference's full-node all-gather before each
    graph-attention layer (``layers/block.py:203``): nodes are contiguously
    sharded by destination, each shard receives only the O(boundary) halo
    pool, and — because edges are partitioned by destination — the per-node
    softmax is complete within a shard (no cross-shard merge needed).
    Edge features are projected shard-locally from the narrow raw attributes.
    """
    b, n, h, d = query.shape
    bc = jnp.asarray(part.boundary_contrib)
    hs = jnp.asarray(part.halo_select)
    hm = jnp.asarray(part.halo_mask)
    le = jnp.asarray(part.local_edges)
    em = jnp.asarray(part.edge_mask)
    scale = 1.0 / (d**0.5)

    def flat_pad(t):
        return pad_nodes(t.reshape(b, n, h * d), part)

    q_pad, k_pad, v_pad = flat_pad(query), flat_pad(key), flat_pad(value)

    def local(q_blk, k_blk, v_blk, bc_blk, hs_blk, hm_blk, le_blk, em_blk, a_blk, w):
        nps = part.nodes_per_shard

        def ext(t_blk):
            contrib = jnp.take(t_blk, bc_blk[0], axis=1)
            pool = jax.lax.all_gather(contrib, axis, axis=1, tiled=True)
            halo = jnp.take(pool, hs_blk[0], axis=1) * hm_blk[0][None, :, None].astype(t_blk.dtype)
            return jnp.concatenate([t_blk, halo], axis=1)

        # every per-edge tensor stays in the FLAT (..., H*D) layout: a small
        # minor dim of D (32 at C=512/H=16) can be padded by the compiler's
        # tiled layouts, H*D cannot, and the (H, D) views below fuse into
        # their reductions unmaterialized.
        k_ext, v_ext = ext(k_blk), ext(v_blk)  # (B, N_ext, H*D)

        edges = le_blk[0]  # (E_pad, 2) [src_ext, dst_local]
        emask = em_blk[0]  # (E_pad,)
        e = a_blk[0] @ w.reshape(-1, h * d)  # shard-local projection, flat

        q_i = jnp.take(q_blk, edges[:, 1], axis=1)
        k_j = jnp.take(k_ext, edges[:, 0], axis=1) + e[None]
        v_j = jnp.take(v_ext, edges[:, 0], axis=1) + e[None]
        logits = jnp.einsum(
            "behd,behd->beh",
            q_i.reshape(b, -1, h, d),
            k_j.reshape(b, -1, h, d),
            preferred_element_type=jnp.float32,
        ) * scale
        logits = jnp.where(emask[None, :, None], logits, -1e30)
        alpha = _segment_softmax_local(logits, edges[:, 1], nps)
        msg = v_j.astype(jnp.float32).reshape(b, -1, h, d) * alpha[..., None]
        msg = msg.reshape(b, -1, h * d) * emask[None, :, None]
        out = segment_sum(msg, edges[:, 1], nps, indices_are_sorted=False)
        return out.astype(q_blk.dtype)

    run = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, axis, None),
            P(None, axis, None),
            P(None, axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None, None),
            P(axis, None),
            P(axis, None, None),
            P(),
        ),
        out_specs=P(None, axis, None),
    )
    out = run(q_pad, k_pad, v_pad, bc, hs, hm, le, em, a_sharded, w_aug)
    return unpad_nodes(out, part).reshape(b, n, h, d)


def _segment_softmax_local(logits: jnp.ndarray, dst: jnp.ndarray, num_dst: int) -> jnp.ndarray:
    """fp32 segment softmax over an unsorted shard-local edge list."""
    m = jax.ops.segment_max(
        jnp.moveaxis(logits, 0, -1), dst, num_segments=num_dst, indices_are_sorted=False
    )
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    shifted = logits - jnp.moveaxis(jnp.take(m, dst, axis=0), -1, 0)
    ex = jnp.exp(shifted)
    z = jax.ops.segment_sum(
        jnp.moveaxis(ex, 0, -1), dst, num_segments=num_dst, indices_are_sorted=False
    )
    denom = jnp.moveaxis(jnp.take(z, dst, axis=0), -1, 0)
    return ex / jnp.maximum(denom, 1e-16)
