"""Processors: stacks of chunked, rematerialized blocks on the hidden mesh.

Counterparts of reference ``layers/processor.py``. Each processor splits
``num_layers`` into ``num_chunks`` chunk modules and wraps each chunk in
``jax.checkpoint`` (``nn.remat``) — the same rematerialization granularity as
the reference's torch ``checkpoint`` calls (``processor.py:73-77``).
``cpu_offload=True`` offloads saved matmul activations to pinned host memory
via the remat policy (see :func:`_remat`) — functional counterpart of the
reference's ``offload_wrapper``.

Graph-based processors bake their (CSR-sorted) edge arrays in as constants at
construction — the build-time analogue of the reference's edge-buffer
registration + 1-hop re-sorting (``processor.py:210,239-246``).
"""

from __future__ import annotations

from typing import Optional

from anemoi_models_tpu import nn
import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.graphs.container import EdgeSet
from anemoi_models_tpu.layers.chunk import (
    GNNProcessorChunk,
    GraphTransformerProcessorChunk,
    TransformerProcessorChunk,
)
from anemoi_models_tpu.layers.graph import TrainableTensor
from anemoi_models_tpu.parallel.api import constrain

__all__ = ["TransformerProcessor", "GNNProcessor", "GraphTransformerProcessor", "HaloGNNProcessor", "register_edges"]


def register_edges(
    sub_graph: EdgeSet, edge_attributes: Optional[list[str]], trainable_size: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Extract (edge_attr, edge_index, edge_dim) from an edge set.

    Counterpart of ``GraphEdgeMixin._register_edges`` (reference
    ``layers/mapper.py:119-148``) minus the batch ``edge_inc`` trick — the
    batch dimension is explicit here, so the same edge arrays serve every
    batch element.
    """
    assert sub_graph is not None, "A valid sub_graph is required to register edges."
    assert edge_attributes is not None, "GNN processor needs the edge-attribute tensor (got None)"
    edge_attr = sub_graph.attr_tensor(list(edge_attributes))
    edge_index = np.asarray(sub_graph.edge_index, dtype=np.int32)
    return edge_attr, edge_index, edge_attr.shape[1] + trainable_size


def _halo_part(sub_graph: EdgeSet, num_dst: int, shards: int):
    """Cached 1-hop halo partition for an edge set (one cache-key scheme
    shared by every caller)."""
    from anemoi_models_tpu.graphs.partition import _edge_set_cache, partition_1hop

    cache = _edge_set_cache(sub_graph)
    key = ("halo_part", num_dst, shards)
    if key not in cache:
        cache[key] = partition_1hop(sub_graph.edge_index, num_dst, shards)
    return cache[key], cache


def _halo_gnn_layout(sub_graph: EdgeSet, num_dst: int, shards: int):
    """(partition, tables): the scatter-free gather layouts — flat padded
    (``HaloGNNTables``) when degrees are near-uniform, degree-bucketed
    (``HaloBucketedTables``) when the worst-shard max degree would make the
    flat padding ruinous (skewed graphs: hub nodes, polar lat/lon rows)."""
    from anemoi_models_tpu.graphs.partition import (
        build_halo_bucketed_tables,
        build_halo_gnn_tables,
    )

    part, cache = _halo_part(sub_graph, num_dst, shards)
    gkey = ("halo_gnn_tables", num_dst, shards)
    if gkey not in cache:
        tables = build_halo_gnn_tables(part)
        mean_deg = float(part.edge_mask.sum()) / max(num_dst, 1)
        if tables.dst_tab.shape[2] > max(32.0, 4.0 * mean_deg):
            # padded width would dwarf the mean degree: bucket it instead
            tables = build_halo_bucketed_tables(part)
        cache[gkey] = tables
    return part, cache[gkey]


def _tables(
    sub_graph: EdgeSet,
    num_dst: int,
    graph_impl: str,
    num_src: Optional[int] = None,
    allow_halo: bool = False,
    gnn_layout: bool = False,
):
    """Edge layout for the conv fast paths.

    - "dense": degree-bucketed neighbor tables (XLA gather path)
    - "segment": None (plain COO segment ops, the reference)

    With ``allow_halo`` (self-graph processors), an active mesh with a >1
    ``model`` axis routes to the halo-partitioned conv by default —
    O(boundary) exchange instead of GSPMD's full k/v gathers.
    ``gnn_layout=True`` (GNN flavor) adds the scatter-free per-shard gather
    layouts the halo GraphConv uses.
    """
    if allow_halo and graph_impl in ("dense", "halo"):
        from anemoi_models_tpu.parallel.api import get_mesh

        mesh = get_mesh()
        if mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1:
            from anemoi_models_tpu.layers.block import HaloTables

            shards = mesh.shape["model"]
            part, _ = _halo_part(sub_graph, num_dst, shards)
            gnn_tables = None
            if gnn_layout:
                _, gnn_tables = _halo_gnn_layout(sub_graph, num_dst, shards)
            return HaloTables(part=part, gnn_tables=gnn_tables)
    if graph_impl != "dense":
        return None
    from anemoi_models_tpu.graphs.partition import edge_set_gather_tables
    from anemoi_models_tpu.ops.dense_graph import GatherTables, TransposeBundle

    buckets, reassemble, bundle = edge_set_gather_tables(sub_graph, num_dst, num_src or num_dst)
    return GatherTables(buckets, reassemble, TransposeBundle(bundle))


def _remat(module_class, remat_policy: str, cpu_offload: bool = False):
    """Wrap a chunk class in nn.remat with the configured policy.

    - "full": recompute everything in the backward (min memory, max FLOPs) —
      the reference's torch-checkpoint behavior.
    - "save_dots": save matmul outputs, recompute elementwise only
      (XLA policy ``dots_with_no_batch_dims_saveable``) — much cheaper
      backward at moderate extra memory.
    - "none": no rematerialization.

    ``cpu_offload=True`` is the equivalent of the reference's
    ``offload_wrapper`` (``layers/processor.py:57-59``): saved matmul
    activations are offloaded to pinned host memory between forward and
    backward instead of being recomputed or kept in HBM.
    """
    if cpu_offload:
        policy = jax.checkpoint_policies.offload_dot_with_no_batch_dims("device", "pinned_host")
        return nn.remat(module_class, policy=policy)
    if remat_policy == "none":
        return module_class
    policy = None
    if remat_policy == "save_dots":
        policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    return nn.remat(module_class, policy=policy)


def _chunk_sizes(num_layers: int, num_chunks: int) -> int:
    assert num_layers % num_chunks == 0, (
        f"Chunked remat needs num_layers ({num_layers}) to split evenly across "
        f"processor chunks ({num_chunks})."
    )
    return num_layers // num_chunks


class TransformerProcessor(nn.Module):
    """Sliding-window transformer over the hidden mesh
    (reference ``processor.py:85-162``)."""

    num_layers: int
    window_size: Optional[int] = None
    num_channels: int = 128
    num_chunks: int = 2
    activation: str = "GELU"
    cpu_offload: bool = False
    num_heads: int = 16
    mlp_hidden_ratio: int = 4
    dropout_p: float = 0.1
    attention_impl: str = "auto"
    remat_policy: str = "full"
    deterministic: bool = True
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, **kwargs) -> jnp.ndarray:
        chunk_size = _chunk_sizes(self.num_layers, self.num_chunks)
        Chunk = _remat(TransformerProcessorChunk, self.remat_policy, self.cpu_offload)
        for c in range(self.num_chunks):
            x = Chunk(
                num_channels=self.num_channels,
                num_layers=chunk_size,
                window_size=self.window_size,
                num_heads=self.num_heads,
                mlp_hidden_ratio=self.mlp_hidden_ratio,
                activation=self.activation,
                dropout_p=self.dropout_p,
                attention_impl=self.attention_impl,
                deterministic=self.deterministic,
                layer_scan=self.layer_scan,
                dtype=self.dtype,
                name=f"proc_{c}",
            )(x)
        return x


class GNNProcessor(nn.Module):
    """Edge-MLP message-passing processor (reference ``processor.py:165-250``)."""

    num_layers: int
    trainable_size: int = 8
    num_channels: int = 128
    num_chunks: int = 2
    mlp_extra_layers: int = 0
    activation: str = "SiLU"
    cpu_offload: bool = False
    sub_graph: Optional[EdgeSet] = None
    sub_graph_edge_attributes: Optional[tuple[str, ...]] = ("edge_length", "edge_dirs")
    src_grid_size: int = 0
    dst_grid_size: int = 0
    graph_impl: str = "dense"
    remat_policy: str = "full"
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, **kwargs) -> jnp.ndarray:
        chunk_size = _chunk_sizes(self.num_layers, self.num_chunks)
        edge_attr_np, edge_index_np, edge_dim = register_edges(
            self.sub_graph, self.sub_graph_edge_attributes, self.trainable_size
        )
        batch_size = x.shape[0]
        edge_attr = TrainableTensor(
            tensor_size=edge_attr_np.shape[0], trainable_size=self.trainable_size, name="trainable"
        )(jnp.asarray(edge_attr_np, dtype=self.dtype), batch_size)
        edge_index = jnp.asarray(edge_index_np)
        tables = _tables(
            self.sub_graph, x.shape[-2], self.graph_impl,
            allow_halo=True, gnn_layout=True,
        )

        Chunk = _remat(GNNProcessorChunk, self.remat_policy, self.cpu_offload)
        for c in range(self.num_chunks):
            x, edge_attr = Chunk(
                num_channels=self.num_channels,
                num_layers=chunk_size,
                mlp_extra_layers=self.mlp_extra_layers,
                activation=self.activation,
                edge_dim=edge_dim if c == 0 else None,  # first chunk embeds edges
                layer_scan=self.layer_scan,
                dtype=self.dtype,
                name=f"proc_{c}",
            )(x, edge_attr, edge_index, tables)
        return constrain(x, ("data", "model", None))


class GraphTransformerProcessor(nn.Module):
    """Per-edge attention processor (reference ``processor.py:253-343``)."""

    num_layers: int
    trainable_size: int = 8
    num_channels: int = 128
    num_chunks: int = 2
    num_heads: int = 16
    mlp_hidden_ratio: int = 4
    activation: str = "GELU"
    cpu_offload: bool = False
    sub_graph: Optional[EdgeSet] = None
    sub_graph_edge_attributes: Optional[tuple[str, ...]] = ("edge_length", "edge_dirs")
    src_grid_size: int = 0
    dst_grid_size: int = 0
    graph_impl: str = "dense"
    kv_src_gather: str = "auto"
    remat_policy: str = "full"
    deterministic: bool = True
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, **kwargs) -> jnp.ndarray:
        chunk_size = _chunk_sizes(self.num_layers, self.num_chunks)
        edge_attr_np, edge_index_np, edge_dim = register_edges(
            self.sub_graph, self.sub_graph_edge_attributes, self.trainable_size
        )
        batch_size = x.shape[0]
        edge_attr = TrainableTensor(
            tensor_size=edge_attr_np.shape[0], trainable_size=self.trainable_size, name="trainable"
        )(jnp.asarray(edge_attr_np, dtype=self.dtype), batch_size)
        edge_index = jnp.asarray(edge_index_np)
        tables = _tables(self.sub_graph, x.shape[-2], self.graph_impl, allow_halo=True)

        Chunk = _remat(GraphTransformerProcessorChunk, self.remat_policy, self.cpu_offload)
        for c in range(self.num_chunks):
            x, edge_attr = Chunk(
                num_channels=self.num_channels,
                num_layers=chunk_size,
                num_heads=self.num_heads,
                mlp_hidden_ratio=self.mlp_hidden_ratio,
                activation=self.activation,
                kv_src_gather=self.kv_src_gather,
                deterministic=self.deterministic,
                layer_scan=self.layer_scan,
                dtype=self.dtype,
                name=f"proc_{c}",
            )(x, edge_attr, edge_index, tables)
        return constrain(x, ("data", "model", None))


class HaloGNNProcessor(nn.Module):
    """Domain-decomposed GNN processor: per-layer 1-hop halo exchange.

    Config-selectable alternative to :class:`GNNProcessor` for multi-chip
    runs: node rows are contiguously sharded over the ``model`` mesh axis and
    each message-passing layer exchanges only the boundary pool
    (``parallel/halo_conv.py``) instead of relying on GSPMD-inserted
    full gathers. Falls back to the regular dense-table path when no mesh is
    active, so the same config runs single-chip.

    The edge-MLP/node-MLP layout matches :class:`GNNProcessor`'s blocks
    (reference ``layers/block.py:170-223``); edge features are embedded once,
    then each layer's updated edges (``msg``) are threaded into the next
    layer shard-locally — the same ``edges_new`` recurrence as GNNProcessor.
    """

    num_layers: int
    trainable_size: int = 8
    num_channels: int = 128
    num_chunks: int = 2  # accepted for config parity; remat applies per layer
    mlp_extra_layers: int = 0
    activation: str = "SiLU"
    cpu_offload: bool = False
    sub_graph: Optional[EdgeSet] = None
    sub_graph_edge_attributes: Optional[tuple[str, ...]] = ("edge_length", "edge_dirs")
    src_grid_size: int = 0
    dst_grid_size: int = 0
    num_shards: Optional[int] = None  # defaults to the mesh's model-axis size
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, **kwargs) -> jnp.ndarray:
        from anemoi_models_tpu.layers.mlp import MLP
        from anemoi_models_tpu.parallel.api import get_mesh
        from anemoi_models_tpu.parallel.halo_conv import halo_graph_conv, shard_edge_values

        mesh = get_mesh()
        num_nodes = x.shape[-2]
        edge_attr_np, edge_index_np, edge_dim = register_edges(
            self.sub_graph, self.sub_graph_edge_attributes, self.trainable_size
        )
        batch_size = x.shape[0]
        edge_attr = TrainableTensor(
            tensor_size=edge_attr_np.shape[0], trainable_size=self.trainable_size, name="trainable"
        )(jnp.asarray(edge_attr_np, dtype=self.dtype), batch_size)
        edge_attr = MLP(
            hidden_dim=self.num_channels,
            out_features=self.num_channels,
            n_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
            name="emb_edges",
        )(edge_attr)

        use_halo = mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1
        if use_halo:
            shards = self.num_shards or mesh.shape["model"]
            assert shards == mesh.shape["model"], (
                f"HaloGNNProcessor num_shards ({shards}) must equal the mesh "
                f"model-axis size ({mesh.shape['model']}): the shard_map "
                f"splits every per-shard array by that axis"
            )
            part, gnn_tables = _halo_gnn_layout(self.sub_graph, num_nodes, shards)
            # shard edge features into the per-shard batched layout
            edge_sharded = shard_edge_values(
                edge_attr, part,
                edge_pos=gnn_tables.edge_pos if gnn_tables is not None else None,
            )
        else:
            edge_index = jnp.asarray(edge_index_np)
            tables = _tables(self.sub_graph, num_nodes, "dense")

        for i in range(self.num_layers):
            conv_params = {
                "w1": self.param(f"conv_{i}_w1", nn.initializers.lecun_normal(), (3 * self.num_channels, self.num_channels), jnp.float32),
                "b1": self.param(f"conv_{i}_b1", nn.initializers.zeros, (self.num_channels,), jnp.float32),
                "w2": self.param(f"conv_{i}_w2", nn.initializers.lecun_normal(), (self.num_channels, self.num_channels), jnp.float32),
                "b2": self.param(f"conv_{i}_b2", nn.initializers.zeros, (self.num_channels,), jnp.float32),
                "w3": self.param(f"conv_{i}_w3", nn.initializers.lecun_normal(), (self.num_channels, self.num_channels), jnp.float32),
                "b3": self.param(f"conv_{i}_b3", nn.initializers.zeros, (self.num_channels,), jnp.float32),
                # final LayerNorm matching GraphConv's MLP(layer_norm=True)
                "ln_s": self.param(f"conv_{i}_ln_s", nn.initializers.ones, (self.num_channels,), jnp.float32),
                "ln_b": self.param(f"conv_{i}_ln_b", nn.initializers.zeros, (self.num_channels,), jnp.float32),
            }
            # edge-space work ((E, 3C) concat + MLP intermediates) dominates
            # memory: rematerialize it per layer in the backward
            # (cpu_offload saves matmul outputs to pinned host memory instead)
            if self.cpu_offload:
                import functools

                ckpt = functools.partial(
                    jax.checkpoint,
                    policy=jax.checkpoint_policies.offload_dot_with_no_batch_dims(
                        "device", "pinned_host"
                    ),
                )
            else:
                ckpt = jax.checkpoint
            if use_halo:
                # updated edges stay shard-local between layers — same
                # threading as GNNProcessor's edges_new, zero extra comms
                def _halo_layer(x_, edges_, params_):
                    return halo_graph_conv(
                        mesh, part, params_, x_, edges_,
                        activation=self.activation, tables=gnn_tables,
                    )

                agg, edge_sharded = ckpt(_halo_layer)(x, edge_sharded, conv_params)
            else:
                from anemoi_models_tpu.ops.dense_graph import bucketed_neighbor_sum
                from anemoi_models_tpu.parallel.halo_conv import apply_edge_mlp

                src, dst = edge_index

                def _dense_layer(x_, edges_, params_):
                    x_i = jnp.take(x_, dst, axis=-2)
                    x_j = jnp.take(x_, src, axis=-2)
                    msg = apply_edge_mlp(
                        params_, jnp.concatenate([x_i, x_j, edges_], -1), self.activation
                    ) + edges_
                    # transpose bundle keeps the aggregation's backward
                    # gather-only (no scatter-adds)
                    return bucketed_neighbor_sum(
                        msg, tables[0], tables[1], transpose=tables[2]
                    ), msg

                agg, edge_attr = ckpt(_dense_layer)(x, edge_attr, conv_params)
            x = MLP(
                hidden_dim=self.num_channels,
                out_features=self.num_channels,
                n_extra_layers=self.mlp_extra_layers,
                activation=self.activation,
                dtype=self.dtype,
                name=f"node_mlp_{i}",
            )(jnp.concatenate([x, agg], axis=-1)) + x
        return constrain(x, ("data", "model", None))
