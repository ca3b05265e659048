"""Mappers: grid↔mesh encoders/decoders over bipartite graphs.

Counterparts of reference ``layers/mapper.py``: GraphTransformer-flavored
(cross-attention restricted to encoder/decoder edges) and GNN-flavored
(edge-MLP message passing) mappers, in Forward (data→hidden) and Backward
(hidden→data) variants.

Sharding: the reference's pre/post-process shard/gather collectives
(``mapper.py:96-116``) become named-sharding constraints on the node tensors;
GSPMD keeps node tensors grid-sharded and inserts edge-gather communication.
"""

from __future__ import annotations

from typing import Optional

from anemoi_models_tpu import nn
import jax
import jax.numpy as jnp

from anemoi_models_tpu.graphs.container import EdgeSet
from anemoi_models_tpu.layers.block import GraphConvMapperBlock, GraphTransformerMapperBlock
from anemoi_models_tpu.layers.graph import TrainableTensor
from anemoi_models_tpu.layers.mlp import MLP
from anemoi_models_tpu.layers.processor import register_edges
from anemoi_models_tpu.layers.utils import AutocastLayerNorm
from anemoi_models_tpu.parallel.api import constrain

__all__ = [
    "GraphTransformerForwardMapper",
    "GraphTransformerBackwardMapper",
    "GNNForwardMapper",
    "GNNBackwardMapper",
]


class _GraphTransformerBaseMapper(nn.Module):
    """Common body of the GraphTransformer mappers
    (reference ``mapper.py:174-272``)."""

    in_channels_src: int = 0
    in_channels_dst: int = 0
    hidden_dim: int = 128
    trainable_size: int = 8
    out_channels_dst: Optional[int] = None
    num_chunks: int = 1
    cpu_offload: bool = False
    activation: str = "GELU"
    num_heads: int = 16
    mlp_hidden_ratio: int = 4
    sub_graph: Optional[EdgeSet] = None
    sub_graph_edge_attributes: Optional[tuple[str, ...]] = ("edge_length", "edge_dirs")
    src_grid_size: int = 0
    dst_grid_size: int = 0
    graph_impl: str = "dense"
    # "commute" (the "auto" default on the dense path): gather the narrow
    # source rows once and move the k/v projections across the gather onto
    # the query/output sides — zero matmuls on the padded slot axis
    # (ops/dense_graph.commuted_edge_attention); "narrow": gather raw source
    # rows once and project k/v after the gather (numerically identical —
    # per-row ops commute with row gathers — and 2–20× fewer gather bytes);
    # "wide": reference dataflow (k/v projected on all rows, two wide
    # gathers).
    kv_src_gather: str = "auto"
    deterministic: bool = True
    dtype: jnp.dtype = jnp.float32

    def _dataflow(self) -> str:
        """Resolved conv dataflow: "commute" | "narrow" | "wide"."""
        if self.kv_src_gather == "auto":
            return "commute" if self.graph_impl == "dense" else "wide"
        if self.kv_src_gather in ("narrow", "commute") and self.graph_impl != "dense":
            import warnings

            # an explicit request that cannot be honored must say so
            # ('auto' degrades silently by design)
            warnings.warn(
                f"kv_src_gather={self.kv_src_gather!r} requires the dense "
                f"bucketed gather tables; graph_impl={self.graph_impl!r} has "
                "none, so the wide dataflow is used instead",
                stacklevel=2,
            )
            return "wide"
        return self.kv_src_gather

    def _narrow(self) -> bool:
        return self._dataflow() in ("narrow", "commute")

    def _edges(self, batch_size: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        edge_attr_np, edge_index_np, _ = register_edges(
            self.sub_graph, self.sub_graph_edge_attributes, self.trainable_size
        )
        edge_attr = TrainableTensor(
            tensor_size=edge_attr_np.shape[0], trainable_size=self.trainable_size, name="trainable"
        )(jnp.asarray(edge_attr_np, dtype=self.dtype), batch_size)
        return edge_attr, jnp.asarray(edge_index_np)

    def _tables(self, num_dst: int, num_src: int):
        if self.graph_impl != "dense":
            return None
        from anemoi_models_tpu.parallel.api import get_mesh

        mesh = get_mesh()
        if (
            mesh is not None
            and "model" in mesh.axis_names
            and mesh.shape["model"] > 1
            and self._narrow()
        ):
            # model-axis parallelism: destination-sharded slot tables + one
            # narrow-src all-gather (parallel/mapper_conv.py) — the mapper
            # analogue of the processor's halo routing
            from anemoi_models_tpu.graphs.partition import mapper_shard_tables

            return mapper_shard_tables(
                self.sub_graph, num_dst, num_src, int(mesh.shape["model"])
            )
        from anemoi_models_tpu.graphs.partition import edge_set_gather_tables
        from anemoi_models_tpu.ops.dense_graph import GatherTables, TransposeBundle

        buckets, reassemble, bundle = edge_set_gather_tables(self.sub_graph, num_dst, num_src)
        return GatherTables(buckets, reassemble, TransposeBundle(bundle))

    def _block(self, src_embed_dim: int = 0) -> nn.Module:
        # remat at the block boundary — the analogue of the model-level
        # mapper checkpointing in reference encoder_processor_decoder.py:159-166;
        # cpu_offload parks saved dots in pinned host memory (ref mapper.py:64-66)
        policy = (
            jax.checkpoint_policies.offload_dot_with_no_batch_dims("device", "pinned_host")
            if self.cpu_offload else None
        )
        Block = nn.remat(GraphTransformerMapperBlock, policy=policy)
        return Block(
            in_channels=self.hidden_dim,
            hidden_dim=self.mlp_hidden_ratio * self.hidden_dim,
            out_channels=self.hidden_dim,
            num_heads=self.num_heads,
            activation=self.activation,
            num_chunks=self.num_chunks,
            kv_src_gather=self._dataflow(),
            src_embed_dim=src_embed_dim,
            dtype=self.dtype,
            name="proc",
        )

    def _run(self, x_src, x_dst, batch_size, src_embed_dim: int = 0):
        """Embed → block → return (x_src_in, x_dst_out) pre-post-processing."""
        edge_attr, edge_index = self._edges(batch_size)
        (x_src, x_dst), _ = self._block(src_embed_dim)(
            (x_src, x_dst), edge_attr, edge_index, x_dst.shape[-2], self.deterministic,
            self._tables(x_dst.shape[-2], x_src.shape[-2]),
        )
        return x_src, x_dst


class GraphTransformerForwardMapper(_GraphTransformerBaseMapper):
    """data → hidden cross-attention encoder (reference ``mapper.py:275-345``).

    Returns ``(x_src_original, x_dst_hidden)`` — the un-embedded source is
    passed through for the decoder's skip path, as in the reference.
    """

    @nn.compact
    def __call__(
        self, x: tuple[jnp.ndarray, jnp.ndarray], batch_size: Optional[int] = None, **kwargs
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        x_src_in, x_dst_in = x
        batch_size = batch_size or x_src_in.shape[0]
        if self._narrow():
            # the source embedding is per-row, so it commutes with the
            # neighbor gather: hand the block the RAW rows and let it embed
            # after the (narrow) gather — the block owns emb_nodes_src
            x_src = constrain(x_src_in, ("data", "model", None))
            src_embed_dim = self.hidden_dim
        else:
            x_src = nn.Dense(self.hidden_dim, dtype=self.dtype, name="emb_nodes_src")(
                constrain(x_src_in, ("data", "model", None))
            )
            src_embed_dim = 0
        x_dst = nn.Dense(self.hidden_dim, dtype=self.dtype, name="emb_nodes_dst")(
            constrain(x_dst_in, ("data", "model", None))
        )
        _, x_dst = self._run(x_src, x_dst, batch_size, src_embed_dim)
        return x_src_in, x_dst


class GraphTransformerBackwardMapper(_GraphTransformerBaseMapper):
    """hidden → data cross-attention decoder (reference ``mapper.py:348-418``)."""

    @nn.compact
    def __call__(
        self, x: tuple[jnp.ndarray, jnp.ndarray], batch_size: Optional[int] = None, **kwargs
    ) -> jnp.ndarray:
        x_src, x_dst_in = x
        batch_size = batch_size or x_src.shape[0]
        x_dst = nn.Dense(self.hidden_dim, dtype=self.dtype, name="emb_nodes_dst")(
            constrain(x_dst_in, ("data", "model", None))
        )
        _, x_dst = self._run(x_src, x_dst, batch_size)
        # node_data_extractor: LN + Linear to out_channels_dst (mapper.py:408-410)
        x_dst = AutocastLayerNorm(name="node_data_extractor_norm")(x_dst)
        x_dst = nn.Dense(self.out_channels_dst, dtype=self.dtype, name="node_data_extractor")(x_dst)
        return constrain(x_dst, ("data", "model", None))


class _GNNBaseMapper(nn.Module):
    """Common body of the GNN mappers (reference ``mapper.py:421-522``)."""

    in_channels_src: int = 0
    in_channels_dst: int = 0
    hidden_dim: int = 128
    trainable_size: int = 8
    out_channels_dst: Optional[int] = None
    num_chunks: int = 1
    cpu_offload: bool = False
    activation: str = "SiLU"
    mlp_extra_layers: int = 0
    sub_graph: Optional[EdgeSet] = None
    sub_graph_edge_attributes: Optional[tuple[str, ...]] = ("edge_length", "edge_dirs")
    src_grid_size: int = 0
    dst_grid_size: int = 0
    graph_impl: str = "dense"
    dtype: jnp.dtype = jnp.float32

    def _tables(self, num_dst: int, num_src: int):
        if self.graph_impl not in ("dense", "segment"):
            raise ValueError(
                "GNN mappers support graph_impl 'dense' or 'segment' (the slot "
                "kernel needs a self-graph; mapper convs are bipartite)"
            )
        if self.graph_impl != "dense":
            return None
        from anemoi_models_tpu.graphs.partition import edge_set_gather_tables
        from anemoi_models_tpu.ops.dense_graph import GatherTables, TransposeBundle

        buckets, reassemble, bundle = edge_set_gather_tables(self.sub_graph, num_dst, num_src)
        return GatherTables(buckets, reassemble, TransposeBundle(bundle))

    def _edges(self, batch_size: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        edge_attr_np, edge_index_np, _ = register_edges(
            self.sub_graph, self.sub_graph_edge_attributes, self.trainable_size
        )
        edge_attr = TrainableTensor(
            tensor_size=edge_attr_np.shape[0], trainable_size=self.trainable_size, name="trainable"
        )(jnp.asarray(edge_attr_np, dtype=self.dtype), batch_size)
        edge_attr = MLP(
            hidden_dim=self.hidden_dim,
            out_features=self.hidden_dim,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
            name="emb_edges",
        )(edge_attr)
        return edge_attr, jnp.asarray(edge_index_np)

    def _block(self, update_src_nodes: bool) -> nn.Module:
        policy = (
            jax.checkpoint_policies.offload_dot_with_no_batch_dims("device", "pinned_host")
            if self.cpu_offload else None
        )
        Block = nn.remat(GraphConvMapperBlock, policy=policy)
        return Block(
            in_channels=self.hidden_dim,
            out_channels=self.hidden_dim,
            mlp_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            update_src_nodes=update_src_nodes,
            num_chunks=self.num_chunks,
            dtype=self.dtype,
            name="proc",
        )


class GNNForwardMapper(_GNNBaseMapper):
    """data → hidden message-passing encoder (reference ``mapper.py:525-608``).

    Returns ``(x_src_hidden_updated, x_dst_hidden)`` — unlike the
    GraphTransformer variant, the source side is embedded to hidden width and
    updated, and the decoder consumes it at hidden width.
    """

    @nn.compact
    def __call__(
        self, x: tuple[jnp.ndarray, jnp.ndarray], batch_size: Optional[int] = None, **kwargs
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        x_src_in, x_dst_in = x
        batch_size = batch_size or x_src_in.shape[0]
        edge_attr, edge_index = self._edges(batch_size)
        mlp_kw = dict(
            hidden_dim=self.hidden_dim,
            out_features=self.hidden_dim,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
        )
        x_src = MLP(**mlp_kw, name="emb_nodes_src")(constrain(x_src_in, ("data", "model", None)))
        x_dst = MLP(**mlp_kw, name="emb_nodes_dst")(constrain(x_dst_in, ("data", "model", None)))
        (x_src, x_dst), _ = self._block(update_src_nodes=True)(
            (x_src, x_dst), edge_attr, edge_index, x_dst.shape[-2], self._tables(x_dst.shape[-2], x_src.shape[-2])
        )
        return x_src, x_dst


class GNNBackwardMapper(_GNNBaseMapper):
    """hidden → data message-passing decoder (reference ``mapper.py:611-705``)."""

    @nn.compact
    def __call__(
        self, x: tuple[jnp.ndarray, jnp.ndarray], batch_size: Optional[int] = None, **kwargs
    ) -> jnp.ndarray:
        x_src, x_dst = x
        batch_size = batch_size or x_src.shape[0]
        edge_attr, edge_index = self._edges(batch_size)
        (_, x_dst), _ = self._block(update_src_nodes=False)(
            (x_src, x_dst), edge_attr, edge_index, x_dst.shape[-2], self._tables(x_dst.shape[-2], x_src.shape[-2])
        )
        # node_data_extractor MLP without final LN/activation (mapper.py:680-688)
        x_dst = MLP(
            hidden_dim=self.hidden_dim,
            out_features=self.out_channels_dst,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            layer_norm=False,
            final_activation=False,
            dtype=self.dtype,
            name="node_data_extractor",
        )(x_dst)
        return constrain(x_dst, ("data", "model", None))
