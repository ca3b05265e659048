"""Graph convolution primitives over CSR-sorted batched edges.

Re-design of reference ``layers/conv.py``: no MessagePassing
machinery — explicit gathers plus sorted segment reductions (see
``ops/segment.py``), batched over a leading (batch·ensemble) dim.

- :class:`GraphConv`: edge-MLP message ``mlp(cat[x_dst_i, x_src_j, e]) + e``,
  scatter-sum aggregation (reference ``conv.py:27-76``).
- :func:`graph_transformer_conv`: per-edge attention
  ``alpha = softmax_dst(q_i · (k_j + e) / sqrt(d))``, message
  ``(v_j + e) * alpha`` (reference ``conv.py:79-142``).
"""

from __future__ import annotations

from typing import Optional, Union

from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.layers.mlp import MLP
from anemoi_models_tpu.ops.dense_graph import (
    bucketed_edge_attention,
    bucketed_neighbor_sum,
    commuted_edge_attention,
)
from anemoi_models_tpu.ops.segment import gather_nodes, segment_softmax, segment_sum

__all__ = ["GraphConv", "graph_transformer_conv"]


class GraphConv(nn.Module):
    """Edge-MLP message passing with sum aggregation.

    Inputs: ``x`` either (B, N, C) for a homogeneous graph or a
    ``(x_src, x_dst)`` pair for bipartite graphs; ``edge_attr`` (B, E, C);
    ``edge_index`` (2, E) CSR-sorted by destination.
    Returns ``(aggregated (B, Nd, C), edges_new (B, E, C))``.
    """

    out_channels: int
    mlp_extra_layers: int = 0
    activation: str = "SiLU"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: Union[jnp.ndarray, tuple[jnp.ndarray, jnp.ndarray]],
        edge_attr,
        edge_index: jnp.ndarray,
        num_dst: Optional[int] = None,
        tables=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        if num_dst is None:
            num_dst = x_dst.shape[-2]
        mlp = MLP(
            hidden_dim=self.out_channels,
            out_features=self.out_channels,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
        )
        if tables is not None:
            from anemoi_models_tpu.layers.block import HaloTables

            if isinstance(tables, HaloTables):
                # multi-chip default under a >1 model axis: 1-hop halo
                # exchange (O(boundary) payload instead of GSPMD's full
                # node gathers, reference block.py:203), running this
                # module's OWN edge MLP shard-locally as a pure function —
                # identical param tree to every other graph_impl
                from anemoi_models_tpu.layers.mlp import apply_mlp_params
                from anemoi_models_tpu.parallel.api import get_mesh
                from anemoi_models_tpu.parallel.halo_conv import (
                    halo_graph_conv,
                    shard_edge_values,
                )

                assert x_src is x_dst, "halo GraphConv requires a self-graph"
                e_width = edge_attr.shape[-1]
                in_width = 2 * x_dst.shape[-1] + e_width
                _ = mlp(jnp.zeros((1, in_width), self.dtype))  # materialize params
                w = mlp.variables["params"]
                if edge_attr.ndim == 3:  # (B, E, C) global edge order
                    edge_sh = shard_edge_values(
                        edge_attr, tables.part,
                        edge_pos=tables.gnn_tables.edge_pos
                        if tables.gnn_tables is not None else None,
                    )
                else:  # already (S, B, E_pad, C) from a previous layer
                    edge_sh = edge_attr
                return halo_graph_conv(
                    get_mesh(), tables.part, w, x_dst, edge_sh,
                    apply_fn=lambda p, cat: apply_mlp_params(
                        p, cat, self.activation, self.dtype
                    ),
                    tables=tables.gnn_tables,
                )
        x_i = gather_nodes(x_dst, edge_index[1])  # destination (target) features
        x_j = gather_nodes(x_src, edge_index[0])  # source features
        edges_new = mlp(jnp.concatenate([x_i, x_j, edge_attr], axis=-1)) + edge_attr
        if tables is not None:
            # degree-bucketed gather + static-width masked
            # reductions instead of a scatter (fwd AND bwd when transpose
            # tables are present)
            buckets, reassemble, *rest = tables
            out = bucketed_neighbor_sum(
                edges_new, buckets, reassemble, transpose=rest[0] if rest else None
            )
        else:
            out = segment_sum(edges_new, edge_index[1], num_dst)
        return out, edges_new


def graph_transformer_conv(
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    edge_attr: Optional[jnp.ndarray],
    edge_index: jnp.ndarray,
    num_dst: Optional[int] = None,
    tables=None,
    edge_transform=None,
    src_transform=None,
    commute=None,
) -> jnp.ndarray:
    """Per-edge multi-head attention restricted to graph edges.

    ``query`` (B, Nd, H, D); ``key``/``value`` (B, Ns, H, D);
    ``edge_attr`` (B, E, H, D) or None; returns (B, Nd, H, D).
    With ``tables`` = (degree buckets, reassemble) from
    ``graphs.partition.bucketed_neighbor_tables``, runs the scatter-free
    path. With ``src_transform`` (bucketed path only), ``key`` is a narrow
    (B, Ns, A) source tensor gathered once and projected to k/v per gathered
    row (see :func:`anemoi_models_tpu.ops.dense_graph.bucketed_edge_attention`).
    With ``commute`` (a :class:`~anemoi_models_tpu.ops.dense_graph.CommutedProj`,
    bucketed path only), ``key`` is the narrow source-feature tensor,
    ``edge_attr`` the raw edge attrs, and the k/v/edge projections run on the
    query/output sides — zero matmuls on the padded slot axis
    (:func:`~anemoi_models_tpu.ops.dense_graph.commuted_edge_attention`).
    """
    if tables is not None:
        buckets, reassemble, *rest = tables
        if commute is not None:
            return commuted_edge_attention(
                query, key, edge_attr, buckets, reassemble, commute,
                transpose=rest[0] if rest else None,
                src_feat_transform=src_transform,
            )
        return bucketed_edge_attention(
            query, key, value, edge_attr, buckets, reassemble, edge_transform,
            transpose=rest[0] if rest else None,
            src_transform=src_transform,
        )
    assert src_transform is None and commute is None, (
        "narrow-source dataflows are a bucketed-tables feature"
    )
    if num_dst is None:
        num_dst = query.shape[-3]
    out_channels = query.shape[-1]

    q_i = jnp.take(query, edge_index[1], axis=-3)
    k_j = jnp.take(key, edge_index[0], axis=-3)
    v_j = jnp.take(value, edge_index[0], axis=-3)
    if edge_attr is not None:
        k_j = k_j + edge_attr
        v_j = v_j + edge_attr

    # fp32 accumulation of the per-edge q·k contraction
    alpha = jnp.einsum(
        "...ehd,...ehd->...eh", q_i, k_j, preferred_element_type=jnp.float32
    ) / jnp.sqrt(jnp.asarray(out_channels, dtype=jnp.float32))
    alpha = segment_softmax(alpha, edge_index[1], num_dst)
    messages = v_j * alpha[..., None]

    # segment ops expect (..., E, C); flatten heads into features and back
    b_dims, (e, h, d) = messages.shape[:-3], messages.shape[-3:]
    out = segment_sum(messages.reshape(*b_dims, e, h * d), edge_index[1], num_dst)
    return out.reshape(*b_dims, num_dst, h, d)
