"""Network blocks: transformer, graph-conv, and graph-transformer bodies.

Counterparts of reference ``layers/block.py``. Communication differences:
where the reference interleaves explicit collectives with compute
(``sync_tensor``/``shard_tensor`` in GraphConv blocks ``block.py:203-219``,
head/sequence all-to-alls in GraphTransformer blocks ``block.py:366-414``),
these blocks annotate shardings (``parallel/api.py``) and let GSPMD insert
collectives. Activation chunking (``ANEMOI_INFERENCE_NUM_CHUNKS``,
``block.py:39,508-527``) maps onto static edge-chunk loops + ``jax.checkpoint``
at the processor level.
"""

from __future__ import annotations

import os
from typing import Optional

from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.layers.attention import MultiHeadSelfAttention
from anemoi_models_tpu.layers.conv import GraphConv, graph_transformer_conv
from anemoi_models_tpu.layers.mlp import MLP
from anemoi_models_tpu.layers.utils import AutocastLayerNorm, get_activation
from anemoi_models_tpu.ops.segment import segment_sum
from anemoi_models_tpu.parallel.api import constrain

__all__ = [
    "TransformerProcessorBlock",
    "GraphConvProcessorBlock",
    "GraphConvMapperBlock",
    "GraphTransformerProcessorBlock",
    "GraphTransformerMapperBlock",
]

import jax


@jax.tree_util.register_static
class HaloTables:
    """Static marker routing a GraphTransformer conv to the halo-partitioned
    execution (``parallel/halo_conv.halo_graph_transformer_conv``) — the
    multi-chip default for self-graph processors under a >1 model axis.
    ``gnn_tables`` (``HaloGNNTables``) give the GNN conv its scatter-free
    gather layouts."""

    def __init__(self, part, gnn_tables=None):
        self.part = part
        self.gnn_tables = gnn_tables


def _affine_from_closure(edge_transform, a_dim: int, num_heads: int, head_dim: int):
    """(A+1, H, D) weights of the affine edge projection ``edge_transform:
    (..., A) -> (..., H, D)``, bias as the last row: probing it with a basis
    recovers ``W`` and ``b`` as parameter-only expressions XLA folds at
    compile time (the halo conv augments attributes with a ones column)."""
    eye = jnp.concatenate([jnp.eye(a_dim), jnp.zeros((1, a_dim))], axis=0)  # (A+1, A)
    probed = edge_transform(eye)  # (A+1, H, D): rows = W + b, last = b
    b = probed[-1]
    w = probed[:-1] - b[None]
    return jnp.concatenate([w, b[None]], axis=0)


def num_chunks_inference() -> int:
    """Edge-chunk count for inference, read from the environment at call time
    (matching the reference's per-call lookup, ``block.py:39``) so setting
    ``ANEMOI_INFERENCE_NUM_CHUNKS`` after import still takes effect."""
    return int(os.environ.get("ANEMOI_INFERENCE_NUM_CHUNKS", "1"))


class TransformerProcessorBlock(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)); x + mlp(LN(x)).

    Reference ``layers/block.py:61-105``.
    """

    num_channels: int
    hidden_dim: int
    num_heads: int
    activation: str = "GELU"
    window_size: Optional[int] = None
    dropout_p: float = 0.0
    attention_impl: str = "auto"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, deterministic: bool = True) -> jnp.ndarray:
        act = get_activation(self.activation)
        x = x + MultiHeadSelfAttention(
            num_heads=self.num_heads,
            embed_dim=self.num_channels,
            window_size=self.window_size,
            bias=False,
            is_causal=False,
            dropout_p=self.dropout_p,
            attention_impl=self.attention_impl,
            dtype=self.dtype,
            name="attention",
        )(AutocastLayerNorm(name="layer_norm1")(x), deterministic=deterministic)
        mlp_out = nn.Dense(self.hidden_dim, dtype=self.dtype)(
            AutocastLayerNorm(name="layer_norm2")(x)
        )
        x = x + nn.Dense(self.num_channels, dtype=self.dtype)(act(mlp_out))
        return constrain(x, ("data", "model", None))


class _GraphConvBase(nn.Module):
    """Shared pieces of the GraphConv processor/mapper blocks
    (reference ``layers/block.py:108-167``)."""

    in_channels: int
    out_channels: int
    mlp_extra_layers: int = 0
    activation: str = "SiLU"
    update_src_nodes: bool = True
    num_chunks: int = 1
    dtype: jnp.dtype = jnp.float32

    def _conv(self) -> GraphConv:
        return GraphConv(
            out_channels=self.out_channels,
            mlp_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
            name="conv",
        )

    def _node_mlp(self) -> MLP:
        return MLP(
            hidden_dim=self.out_channels,
            out_features=self.out_channels,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
            name="node_mlp",
        )

    def _run_conv(self, conv, x, edge_attr, edge_index, num_dst, tables=None):
        """Optionally edge-chunked conv (reference ``block.py:205-217``).

        With dense neighbor ``tables`` the scatter-free path is used and edge
        chunking is unnecessary (aggregation is a static-width reduction).
        """
        num_chunks = max(self.num_chunks, 1)
        if tables is not None or num_chunks == 1:
            return conv(x, edge_attr, edge_index, num_dst, tables)
        e = edge_attr.shape[-2]
        bounds = [round(i * e / num_chunks) for i in range(num_chunks + 1)]
        out = None
        edges_out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out1, edges1 = conv(x, edge_attr[..., lo:hi, :], edge_index[:, lo:hi], num_dst)
            edges_out.append(edges1)
            out = out1 if out is None else out + out1
        return out, jnp.concatenate(edges_out, axis=-2)


class GraphConvProcessorBlock(_GraphConvBase):
    """Homogeneous-graph message-passing block (reference ``block.py:170-223``)."""

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        num_dst: Optional[int] = None,
        tables=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        out, edges_new = self._run_conv(
            self._conv(), x, edge_attr, edge_index, num_dst or x.shape[-2], tables
        )
        out = constrain(out, ("data", "model", None))
        nodes_new = self._node_mlp()(jnp.concatenate([x, out], axis=-1)) + x
        return constrain(nodes_new, ("data", "model", None)), edges_new


class GraphConvMapperBlock(_GraphConvBase):
    """Bipartite-graph message-passing block (reference ``block.py:226-286``)."""

    @nn.compact
    def __call__(
        self,
        x: tuple[jnp.ndarray, jnp.ndarray],
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        num_dst: Optional[int] = None,
        tables=None,
    ) -> tuple[tuple[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
        x_src, x_dst = x
        out, edges_new = self._run_conv(
            self._conv(), (x_src, x_dst), edge_attr, edge_index, num_dst or x_dst.shape[-2], tables
        )
        out = constrain(out, ("data", "model", None))
        node_mlp = self._node_mlp()
        nodes_new_dst = node_mlp(jnp.concatenate([x_dst, out], axis=-1)) + x_dst
        # src update only needed in the forward mapper (reference block.py:281-282);
        # the reference reuses the same node_mlp weights for it.
        if self.update_src_nodes:
            nodes_new_src = node_mlp(jnp.concatenate([x_src, x_src], axis=-1)) + x_src
        else:
            nodes_new_src = x_src
        return (nodes_new_src, nodes_new_dst), edges_new


class _GraphTransformerBase(nn.Module):
    """Shared pieces of the GraphTransformer blocks (reference
    ``layers/block.py:289-426``)."""

    in_channels: int
    hidden_dim: int
    out_channels: int
    num_heads: int = 16
    bias: bool = True
    activation: str = "GELU"
    num_chunks: int = 1
    dtype: jnp.dtype = jnp.float32

    def _probe_affine(self, layer: nn.Module, in_dim: int):
        """(W, b) of a Dense, read out at trace time by one (in_dim+1)-row
        identity pass through the layer — the parameter tree stays exactly
        the layer's own, but the weights become available as arrays for the
        commuted dataflow (XLA folds ``eye @ W`` away).

        Precision: W is recovered as ``(W + b) - b`` in the module compute
        dtype, so in bf16 each recovered weight carries absolute error up to
        ~eps_bf16 * |b| of its column's bias — a systematic perturbation on
        top of the fp reassociation the commuted dataflow already accepts
        (weights much smaller than their column's bias are quantized away).
        Harmless at bf16 training/serving tolerances (the products feeding
        the attention logits carry the same-order rounding anyway); if
        tighter parity is ever needed, read the params directly instead of
        probing."""
        probe = jnp.concatenate(
            [jnp.eye(in_dim, dtype=self.dtype), jnp.zeros((1, in_dim), self.dtype)], axis=0
        )
        wb = layer(probe)
        # Dense adds the bias to EVERY row: eye @ W + b = W + b, 0 @ W + b = b
        return wb[:-1] - wb[-1], wb[-1]

    def _commuted_proj(self, w_kv, b_kv, lin_edge, edge_dim: int):
        """Build a :class:`CommutedProj` from probed [k|v] and edge affines."""
        from anemoi_models_tpu.ops.dense_graph import CommutedProj

        width = self.num_heads * self.out_channels_conv
        hd = (self.num_heads, self.out_channels_conv)
        w_e, b_e = self._probe_affine(lin_edge, edge_dim)
        return CommutedProj(
            w_k=w_kv[:, :width].reshape(-1, *hd),
            w_v=w_kv[:, width:].reshape(-1, *hd),
            w_e=w_e.reshape(edge_dim, *hd),
            # k-side biases are constant over a destination's neighbors —
            # softmax-invariant, dropped; v/edge biases land on the output
            b_out=(b_kv[width:] + b_e).reshape(hd),
        )

    @property
    def out_channels_conv(self) -> int:
        assert self.out_channels % self.num_heads == 0, (
            f"out_channels ({self.out_channels}) must be divisible by "
            f"num_heads ({self.num_heads})"
        )
        return self.out_channels // self.num_heads

    def _heads(self, t: jnp.ndarray) -> jnp.ndarray:
        """(B, N, H*D) -> (B, N, H, D), head axis constrained to the model
        mesh axis during edge attention (GSPMD inserts the seq<->heads
        all-to-all the reference hand-writes, ``block.py:366-398``)."""
        b, n, _ = t.shape
        t = t.reshape(b, n, self.num_heads, self.out_channels_conv)
        return constrain(t, ("data", None, "model", None))

    def _edge_dense(self) -> nn.Dense:
        width = self.num_heads * self.out_channels_conv
        return nn.Dense(width, dtype=self.dtype, name="lin_edge")

    def _edge_transform(self, lin_edge: nn.Dense):
        """Project raw gathered edge attrs (..., cap, A) -> (..., cap, H, D)."""

        def transform(e_raw):
            e = lin_edge(e_raw)
            return e.reshape(*e.shape[:-1], self.num_heads, self.out_channels_conv)

        return transform

    def _conv_chunked(self, query, key, value, edges, edge_index, num_dst, num_chunks, tables=None, edge_transform=None, src_transform=None, commute=None):
        """Edge-chunked per-edge attention. Chunking splits the (CSR-sorted)
        edge set, so per-destination softmax normalization must span chunks:
        compute unnormalized exp-weighted sums + normalizers per chunk and
        combine (reference instead re-sorts chunks 1-hop, ``block.py:510-527``).

        With dense ``tables`` the scatter-free path is used unchunked (its
        live memory is already bounded by the padded degree).
        """
        if isinstance(tables, HaloTables):
            assert src_transform is None and commute is None, (
                "narrow-source dataflows are a bucketed-tables feature"
            )
            from anemoi_models_tpu.parallel.api import get_mesh
            from anemoi_models_tpu.parallel.halo_conv import (
                halo_graph_transformer_conv,
                shard_edge_values,
            )

            mesh = get_mesh()
            a0 = edges[0]  # raw edge attrs, batch-invariant
            a_sh = shard_edge_values(a0, tables.part)  # (S, E_pad, A)
            a_sh = jnp.concatenate([a_sh, jnp.ones_like(a_sh[..., :1])], axis=-1)
            w_aug = _affine_from_closure(
                edge_transform, a0.shape[-1], self.num_heads, self.out_channels_conv
            )
            return halo_graph_transformer_conv(
                mesh, tables.part, query, key, value, a_sh, w_aug.astype(a_sh.dtype)
            )
        if tables is not None or num_chunks <= 1:
            return graph_transformer_conv(
                query, key, value, edges, edge_index, num_dst, tables, edge_transform,
                src_transform=src_transform, commute=commute,
            )
        assert src_transform is None and commute is None, (
            "narrow-source dataflows are a bucketed-tables feature"
        )
        # Flash-style two-pass over edge chunks: pass 1 accumulates the
        # per-destination max logit, pass 2 the exp-weighted sums. Correct
        # softmax across chunk boundaries at O(E/num_chunks) live memory.
        scale = 1.0 / jnp.sqrt(jnp.asarray(self.out_channels_conv, jnp.float32))
        e = edges.shape[-3]
        bounds = [round(i * e / num_chunks) for i in range(num_chunks + 1)]

        def chunk_logits(lo: int, hi: int):
            ei = edge_index[:, lo:hi]
            q_i = jnp.take(query, ei[1], axis=-3)
            k_j = jnp.take(key, ei[0], axis=-3) + edges[..., lo:hi, :, :]
            # fp32-accumulated contraction, consistent with the unchunked paths
            logits = jnp.einsum("...ehd,...ehd->...eh", q_i, k_j, preferred_element_type=jnp.float32)
            return ei, logits * scale  # (B, e, H)

        from anemoi_models_tpu.ops.segment import segment_max

        seg_max = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            ei, logits = chunk_logits(lo, hi)
            m1 = segment_max(logits, ei[1], num_dst)
            seg_max = m1 if seg_max is None else jnp.maximum(seg_max, m1)
        seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)

        num = None
        den = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            ei, logits = chunk_logits(lo, hi)
            w = jnp.exp(logits - jnp.take(seg_max, ei[1], axis=-2))
            v_j = jnp.take(value, ei[0], axis=-3) + edges[..., lo:hi, :, :]
            msg = v_j * w[..., None].astype(v_j.dtype)
            b_dims, (ec, h, d) = msg.shape[:-3], msg.shape[-3:]
            n1 = segment_sum(msg.reshape(*b_dims, ec, h * d), ei[1], num_dst)
            d1 = segment_sum(w, ei[1], num_dst)
            num = n1 if num is None else num + n1
            den = d1 if den is None else den + d1
        b_dims = num.shape[:-2]
        num = num.reshape(*b_dims, num_dst, self.num_heads, self.out_channels_conv)
        return num / jnp.maximum(den, 1e-16)[..., None].astype(num.dtype)

    def _dst_mlp(self, name: str) -> nn.Module:
        act = get_activation(self.activation)

        class _Mlp(nn.Module):
            hidden_dim: int
            out_channels: int
            dtype: jnp.dtype

            @nn.compact
            def __call__(self, x):
                x = AutocastLayerNorm()(x)
                x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)
                x = act(x)
                return nn.Dense(self.out_channels, dtype=self.dtype)(x)

        return _Mlp(hidden_dim=self.hidden_dim, out_channels=self.out_channels, dtype=self.dtype, name=name)


class GraphTransformerProcessorBlock(_GraphTransformerBase):
    """Per-edge attention block on a homogeneous graph
    (reference ``block.py:553-635``).

    ``kv_src_gather="commute"`` (the "auto" default on the dense bucketed
    path) gathers the LayerNormed node rows ONCE and moves the k/v/edge
    projections across the gather onto the query/output sides
    (:func:`~anemoi_models_tpu.ops.dense_graph.commuted_edge_attention`):
    half the wide path's gather bytes, zero matmuls on the padded slot axis,
    identical parameter tree (the fused ``lin_qkvs`` kernel is probed, not
    split)."""

    kv_src_gather: str = "auto"

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        num_dst: Optional[int] = None,
        deterministic: bool = True,
        tables=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        from anemoi_models_tpu.ops.dense_graph import GatherTables

        num_dst = num_dst or x.shape[-2]
        x_skip = x
        x = AutocastLayerNorm(name="layer_norm1")(x)
        width = self.num_heads * self.out_channels_conv
        lin_qkvs = nn.Dense(4 * width, use_bias=self.bias, dtype=self.dtype, name="lin_qkvs")
        lin_edge = self._edge_dense()
        commutable = isinstance(tables, GatherTables)
        if self.kv_src_gather == "narrow" or (
            self.kv_src_gather == "commute" and not commutable
        ):
            # an explicit request that cannot be honored must say so (the
            # mapper block warns in the same situation); "auto" stays silent
            import warnings

            reason = (
                "the processor has no narrow dataflow — its source rows ARE the "
                "node features; use 'commute' or 'auto'"
                if self.kv_src_gather == "narrow"
                else f"tables are {type(tables).__name__}, not dense GatherTables"
            )
            warnings.warn(
                f"kv_src_gather={self.kv_src_gather!r} cannot be honored on the "
                f"processor block ({reason}); using the wide dataflow",
                stacklevel=2,
            )
        if self.kv_src_gather in ("auto", "commute") and commutable:
            w, b = self._probe_affine(lin_qkvs, x.shape[-1])
            # query + self projections run on the nodes as usual (columns
            # [q | r] of the fused kernel); k/v columns ride the conv commuted
            w_qr = jnp.concatenate([w[:, :width], w[:, 3 * width:]], axis=-1)
            b_qr = jnp.concatenate([b[:width], b[3 * width:]], axis=-1)
            query, x_r = jnp.split(x @ w_qr + b_qr, 2, axis=-1)
            proj = self._commuted_proj(
                w[:, width: 3 * width], b[width: 3 * width], lin_edge, edge_attr.shape[-1]
            )
            out = self._conv_chunked(
                self._heads(query), x, None, edge_attr, edge_index, num_dst, 1,
                tables, commute=proj,
            )
            b_, n_ = out.shape[0], out.shape[1]
            out = constrain(out, ("data", None, "model", None)).reshape(b_, n_, self.out_channels)
            out = constrain(out, ("data", "model", None))
            out = nn.Dense(self.out_channels, dtype=self.dtype, name="projection")(out + x_r)
            out = out + x_skip
            nodes_new = self._dst_mlp("node_dst_mlp")(out) + out
            return constrain(nodes_new, ("data", "model", None)), edge_attr
        # one fused matmul for query/key/value/self (all project the same x)
        qkvs = lin_qkvs(x)
        query, key, value, x_r = jnp.split(qkvs, 4, axis=-1)
        halo = isinstance(tables, HaloTables)
        if halo:
            # node axis stays sharded; the halo shard_map owns the layout
            b_, n_ = x.shape[0], x.shape[1]
            query, key, value = (
                t.reshape(b_, n_, self.num_heads, self.out_channels_conv)
                for t in (query, key, value)
            )
            edges = edge_attr
        elif tables is not None:
            query, key, value = map(self._heads, (query, key, value))
            edges = edge_attr  # raw; projected per bucket after the narrow gather
        else:
            edges = lin_edge(edge_attr)
            query, key, value, edges = map(self._heads, (query, key, value, edges))

        num_chunks = self.num_chunks if not deterministic else max(self.num_chunks, num_chunks_inference())
        out = self._conv_chunked(
            query, key, value, edges, edge_index, num_dst, num_chunks, tables,
            edge_transform=self._edge_transform(lin_edge) if tables is not None else None,
        )
        b, n = out.shape[0], out.shape[1]
        if not halo:
            out = constrain(out, ("data", None, "model", None))
        out = out.reshape(b, n, self.out_channels)
        out = constrain(out, ("data", "model", None))

        out = nn.Dense(self.out_channels, dtype=self.dtype, name="projection")(out + x_r)
        out = out + x_skip
        nodes_new = self._dst_mlp("node_dst_mlp")(out) + out
        return constrain(nodes_new, ("data", "model", None)), edge_attr


class GraphTransformerMapperBlock(_GraphTransformerBase):
    """Per-edge attention block on a bipartite graph
    (reference ``block.py:429-550``).

    ``src_embed_dim`` > 0 moves the source-node embedding (the mapper's
    ``emb_nodes_src`` in the reference layout) into this block so it can run
    *after* the neighbor gather on the narrow raw rows. ``kv_src_gather``:

    - ``"wide"`` (reference dataflow): project k/v on all source rows, then
      gather the two (H*D)-wide tensors per destination bucket;
    - ``"narrow"``: gather the raw source rows once per bucket and apply the
      per-row chain (embed → LayerNorm → k/v projection) on the gathered
      rows. Per-row ops commute with row gathers, so this is numerically the
      same computation with ~2×–20× fewer gather bytes (encoder: the raw
      rows are ~22-wide vs 2×256-wide k/v) at extra matmul FLOPs on the padded
      rows — the better trade for a bytes-bound model. Requires dense bucketed tables; any
      other aggregation layout falls back to the wide dataflow.
    """

    update_src_nodes: bool = False
    src_embed_dim: int = 0
    kv_src_gather: str = "wide"

    @nn.compact
    def __call__(
        self,
        x: tuple[jnp.ndarray, jnp.ndarray],
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        num_dst: Optional[int] = None,
        deterministic: bool = True,
        tables=None,
    ) -> tuple[tuple[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
        from anemoi_models_tpu.ops.dense_graph import GatherTables

        x_skip = x
        num_dst = num_dst or x[1].shape[-2]
        ln_src = AutocastLayerNorm(name="layer_norm1")
        emb_src = (
            nn.Dense(self.src_embed_dim, dtype=self.dtype, name="emb_nodes_src")
            if self.src_embed_dim
            else None
        )
        width = self.num_heads * self.out_channels_conv
        lin_kv = nn.Dense(2 * width, dtype=self.dtype, name="lin_kv")
        x_dst = AutocastLayerNorm(name="layer_norm2")(x[1])
        # fused matmuls: [query|self] from dst, [key|value] from src
        qs = nn.Dense(2 * width, use_bias=self.bias, dtype=self.dtype, name="lin_qs")(x_dst)
        query, x_r = jnp.split(qs, 2, axis=-1)
        lin_edge = self._edge_dense()

        from anemoi_models_tpu.graphs.partition import MapperShardTables

        if isinstance(tables, MapperShardTables):
            # destination-sharded mapper attention under a model axis: one
            # narrow-src all-gather, shard-local slot attention, no head
            # resharding (parallel/mapper_conv.py)
            assert not self.update_src_nodes, (
                "sharded mapper tables require update_src_nodes=False"
            )
            from anemoi_models_tpu.parallel.api import get_mesh
            from anemoi_models_tpu.parallel.mapper_conv import sharded_mapper_edge_attention

            def src_transform_sharded(g):
                if emb_src is not None:
                    g = emb_src(g)
                k_n, v_n = jnp.split(lin_kv(ln_src(g)), 2, axis=-1)
                shape = (*k_n.shape[:-1], self.num_heads, self.out_channels_conv)
                return k_n.reshape(shape), v_n.reshape(shape)

            if self.is_initializing():
                # materialize the transform params OUTSIDE the shard_map
                # region (param creation inside shard_map is unsupported;
                # established params are closure-captured replicated)
                src_transform_sharded(x[0][:, :1, None, :])
                self._edge_transform(lin_edge)(edge_attr[..., :1, :])

            commute_kw = {}
            if self.kv_src_gather in ("auto", "commute"):
                # zero-slot-matmul dataflow: the (H·D) k/v slot slabs — the
                # dominant O1280 temp term — never exist; probes run OUTSIDE
                # the shard_map, so weights enter as replicated captures.
                # lin_kv consumes the embedded rows when emb_src is present,
                # so the probe fan-in is the embed width, not in_channels
                w_kv, b_kv = self._probe_affine(
                    lin_kv, self.src_embed_dim or self.in_channels
                )
                proj = self._commuted_proj(w_kv, b_kv, lin_edge, edge_attr.shape[-1])
                if emb_src is not None:
                    commute_kw = dict(
                        commute=proj,
                        src_feat_transform=lambda g: ln_src(emb_src(g)),
                    )
                else:
                    commute_kw = dict(commute=proj)

            bq = query.shape[0]
            query_h = constrain(
                query.reshape(bq, -1, self.num_heads, self.out_channels_conv),
                ("data", "model", None, None),
            )
            # cast raw rows to the compute dtype BEFORE the all-gather and
            # slot gathers: everything downstream is self.dtype anyway, and
            # the slot tensors are the largest arrays in the sharded mapper
            src_rows = x[0]
            if commute_kw and emb_src is None:
                # LN is per-row: run it on the (sharded) source nodes and
                # gather its output — no per-slot LN in the commuted dataflow
                src_rows = ln_src(src_rows)
            src_rows = constrain(src_rows.astype(self.dtype), ("data", "model", None))
            out = sharded_mapper_edge_attention(
                get_mesh(), tables, query_h, src_rows, edge_attr.astype(self.dtype),
                self._edge_transform(lin_edge), src_transform_sharded,
                num_chunks=(
                    self.num_chunks
                    if not deterministic
                    else max(self.num_chunks, num_chunks_inference())
                ),
                **commute_kw,
            )
            out = constrain(out, ("data", "model", None, None)).reshape(
                bq, num_dst, self.out_channels
            )
            out = constrain(out, ("data", "model", None))
            out = nn.Dense(self.out_channels, dtype=self.dtype, name="projection")(out + x_r)
            out = out + x_skip[1]
            nodes_new_dst = self._dst_mlp("node_dst_mlp")(out) + out
            return (x_skip[0], nodes_new_dst), edge_attr

        # narrow/commute need the bucketed tables AND an unused src output
        # (with update_src_nodes the src MLP consumes the embedded rows,
        # which these paths never materialize)
        mode = self.kv_src_gather
        if mode in ("narrow", "commute") and not (
            isinstance(tables, GatherTables) and not self.update_src_nodes
        ):
            import warnings

            reason = (
                "update_src_nodes=True consumes the embedded source rows the narrow path never materializes"
                if self.update_src_nodes
                else f"tables are {type(tables).__name__}, not dense GatherTables"
            )
            warnings.warn(
                f"kv_src_gather={mode!r} cannot be honored ({reason}); using the wide dataflow",
                stacklevel=2,
            )
            mode = "wide"
        narrow = mode == "narrow"
        if mode == "commute":
            # zero-slot-matmul dataflow: gather the narrow source rows once,
            # k/v/edge projections commuted onto the query/output sides
            query = self._heads(query)
            if emb_src is not None:
                # the embed→LN prefix is nonlinear per-row: it commutes with
                # the gather (runs on gathered raw rows) but not with w_kv
                src_feats = x[0].astype(self.dtype)
                src_feat_transform = lambda g: ln_src(emb_src(g))  # noqa: E731
            else:
                # LN is per-row too — run it on the nodes, gather its output
                src_feats = ln_src(x[0]).astype(self.dtype)
                src_feat_transform = None
            # probe with lin_kv's true fan-in: the embed width when the
            # source rows are embedded first, in_channels otherwise
            w_kv, b_kv = self._probe_affine(
                lin_kv, self.src_embed_dim or self.in_channels
            )
            proj = self._commuted_proj(w_kv, b_kv, lin_edge, edge_attr.shape[-1])
            num_chunks = (
                self.num_chunks if not deterministic
                else max(self.num_chunks, num_chunks_inference())
            )
            out = self._conv_chunked(
                query, src_feats, None, edge_attr, edge_index, num_dst, num_chunks,
                tables, src_transform=src_feat_transform, commute=proj,
            )
            b = out.shape[0]
            out = constrain(out, ("data", None, "model", None)).reshape(
                b, num_dst, self.out_channels
            )
            out = constrain(out, ("data", "model", None))
            out = nn.Dense(self.out_channels, dtype=self.dtype, name="projection")(out + x_r)
            out = out + x_skip[1]
            nodes_new_dst = self._dst_mlp("node_dst_mlp")(out) + out
            return (x_skip[0], nodes_new_dst), edge_attr
        if narrow:
            query = self._heads(query)
            edges = edge_attr

            def src_transform(g):
                """(…, cap, A) raw source rows -> k, v (…, cap, H, D)."""
                if emb_src is not None:
                    g = emb_src(g)
                k_n, v_n = jnp.split(lin_kv(ln_src(g)), 2, axis=-1)
                shape = (*k_n.shape[:-1], self.num_heads, self.out_channels_conv)
                return k_n.reshape(shape), v_n.reshape(shape)

            key, value = x[0], None  # narrow source rows, gathered in the conv
        else:
            src_transform = None
            x_src = x[0] if emb_src is None else emb_src(x[0])
            x_skip = (x_src, x[1])  # src skip operates on embedded rows
            kv = lin_kv(ln_src(x_src))
            key, value = jnp.split(kv, 2, axis=-1)
            if tables is not None:
                query, key, value = map(self._heads, (query, key, value))
                edges = edge_attr
            else:
                edges = lin_edge(edge_attr)
                query, key, value, edges = map(self._heads, (query, key, value, edges))

        num_chunks = self.num_chunks if not deterministic else max(self.num_chunks, num_chunks_inference())
        out = self._conv_chunked(
            query, key, value, edges, edge_index, num_dst, num_chunks, tables,
            edge_transform=self._edge_transform(lin_edge) if tables is not None else None,
            src_transform=src_transform,
        )
        b = out.shape[0]
        out = constrain(out, ("data", None, "model", None)).reshape(b, num_dst, self.out_channels)
        out = constrain(out, ("data", "model", None))

        out = nn.Dense(self.out_channels, dtype=self.dtype, name="projection")(out + x_r)
        out = out + x_skip[1]
        nodes_new_dst = self._dst_mlp("node_dst_mlp")(out) + out
        if self.update_src_nodes:
            nodes_new_src = self._dst_mlp("node_src_mlp")(x_skip[0]) + x_skip[0]
        else:
            nodes_new_src = x_skip[0]
        return (nodes_new_src, nodes_new_dst), edge_attr
