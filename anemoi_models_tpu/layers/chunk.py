"""Processor chunks: groups of blocks forming one rematerialization unit.

Counterpart of reference ``layers/chunk.py``: a processor splits its
``num_layers`` into ``num_chunks`` chunk modules; each chunk is the
activation-checkpoint boundary (``jax.checkpoint`` here, torch
``checkpoint`` there — reference ``layers/processor.py:73-77``).

``layer_scan=True`` runs a chunk's blocks through ``nn.scan`` over stacked
per-layer parameters instead of a Python-unrolled loop: the block body
appears ONCE in the traced program regardless of depth. This is a
program-size lever — at O1280 the SPMD partitioner's host memory scales
with the (unrolled) program — at the cost of a different parameter layout
(leading layer axis). Numerics are identical to the unrolled loop (tests
pin it).
"""

from __future__ import annotations

from typing import Any, Optional

from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.layers.block import (
    GraphConvProcessorBlock,
    GraphTransformerProcessorBlock,
    TransformerProcessorBlock,
)
from anemoi_models_tpu.layers.mlp import MLP

__all__ = ["TransformerProcessorChunk", "GNNProcessorChunk", "GraphTransformerProcessorChunk"]


def _scan_layers(step_cls: type, length: int, **step_kwargs):
    """nn.scan a one-block step module: params stack on a leading layer
    axis, rngs split per layer, non-carry call args broadcast."""
    return nn.scan(step_cls, length=length)(**step_kwargs)


class _TransformerScanStep(nn.Module):
    num_channels: int
    hidden_dim: int
    num_heads: int
    activation: str
    window_size: Optional[int]
    dropout_p: float
    attention_impl: str
    deterministic: bool
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x, _):
        x = TransformerProcessorBlock(
            num_channels=self.num_channels,
            hidden_dim=self.hidden_dim,
            num_heads=self.num_heads,
            activation=self.activation,
            window_size=self.window_size,
            dropout_p=self.dropout_p,
            attention_impl=self.attention_impl,
            dtype=self.dtype,
            name="block",
        )(x, deterministic=self.deterministic)
        return x, ()


class _GNNScanStep(nn.Module):
    num_channels: int
    mlp_extra_layers: int
    activation: str
    tables: Any
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, carry, edge_index):
        x, edge_attr = carry
        x, edge_attr = GraphConvProcessorBlock(
            in_channels=self.num_channels,
            out_channels=self.num_channels,
            mlp_extra_layers=self.mlp_extra_layers,
            activation=self.activation,
            dtype=self.dtype,
            name="block",
        )(x, edge_attr, edge_index, None, self.tables)
        return (x, edge_attr), ()


class _GTScanStep(nn.Module):
    num_channels: int
    hidden_dim: int
    num_heads: int
    activation: str
    kv_src_gather: str
    deterministic: bool
    tables: Any
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, carry, edge_index):
        x, edge_attr = carry
        x, edge_attr = GraphTransformerProcessorBlock(
            in_channels=self.num_channels,
            hidden_dim=self.hidden_dim,
            out_channels=self.num_channels,
            num_heads=self.num_heads,
            activation=self.activation,
            kv_src_gather=self.kv_src_gather,
            dtype=self.dtype,
            name="block",
        )(x, edge_attr, edge_index, None, self.deterministic, self.tables)
        return (x, edge_attr), ()


class TransformerProcessorChunk(nn.Module):
    """num_layers sliding-window transformer blocks (reference ``chunk.py:66-114``)."""

    num_channels: int
    num_layers: int
    window_size: Optional[int]
    num_heads: int = 16
    mlp_hidden_ratio: int = 4
    activation: str = "GELU"
    dropout_p: float = 0.0
    attention_impl: str = "auto"
    deterministic: bool = True
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.layer_scan:
            x, _ = _scan_layers(
                _TransformerScanStep,
                self.num_layers,
                num_channels=self.num_channels,
                hidden_dim=self.mlp_hidden_ratio * self.num_channels,
                num_heads=self.num_heads,
                activation=self.activation,
                window_size=self.window_size,
                dropout_p=self.dropout_p,
                attention_impl=self.attention_impl,
                deterministic=self.deterministic,
                dtype=self.dtype,
                name="blocks",
            )(x, ())
            return x
        for i in range(self.num_layers):
            x = TransformerProcessorBlock(
                num_channels=self.num_channels,
                hidden_dim=self.mlp_hidden_ratio * self.num_channels,
                num_heads=self.num_heads,
                activation=self.activation,
                window_size=self.window_size,
                dropout_p=self.dropout_p,
                attention_impl=self.attention_impl,
                dtype=self.dtype,
                name=f"blocks_{i}",
            )(x, deterministic=self.deterministic)
        return x


class GNNProcessorChunk(nn.Module):
    """num_layers message-passing blocks; the first chunk embeds edges
    (reference ``chunk.py:117-181``, ``processor.py:223-224``)."""

    num_channels: int
    num_layers: int
    mlp_extra_layers: int = 0
    activation: str = "SiLU"
    edge_dim: Optional[int] = None
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        tables=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        if self.edge_dim:
            edge_attr = MLP(
                hidden_dim=self.num_channels,
                out_features=self.num_channels,
                n_extra_layers=self.mlp_extra_layers,
                activation=self.activation,
                dtype=self.dtype,
                name="emb_edges",
            )(edge_attr)
        if self.layer_scan:
            (x, edge_attr), _ = _scan_layers(
                _GNNScanStep,
                self.num_layers,
                num_channels=self.num_channels,
                mlp_extra_layers=self.mlp_extra_layers,
                activation=self.activation,
                tables=tables,
                dtype=self.dtype,
                name="blocks",
            )((x, edge_attr), edge_index)
            return x, edge_attr
        for i in range(self.num_layers):
            x, edge_attr = GraphConvProcessorBlock(
                in_channels=self.num_channels,
                out_channels=self.num_channels,
                mlp_extra_layers=self.mlp_extra_layers,
                activation=self.activation,
                dtype=self.dtype,
                name=f"blocks_{i}",
            )(x, edge_attr, edge_index, None, tables)
        return x, edge_attr


class GraphTransformerProcessorChunk(nn.Module):
    """num_layers per-edge-attention blocks (reference ``chunk.py:184-238``)."""

    num_channels: int
    num_layers: int
    num_heads: int = 16
    mlp_hidden_ratio: int = 4
    activation: str = "GELU"
    kv_src_gather: str = "auto"
    deterministic: bool = True
    layer_scan: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        edge_attr: jnp.ndarray,
        edge_index: jnp.ndarray,
        tables=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        if self.layer_scan:
            (x, edge_attr), _ = _scan_layers(
                _GTScanStep,
                self.num_layers,
                num_channels=self.num_channels,
                hidden_dim=self.mlp_hidden_ratio * self.num_channels,
                num_heads=self.num_heads,
                activation=self.activation,
                kv_src_gather=self.kv_src_gather,
                deterministic=self.deterministic,
                tables=tables,
                dtype=self.dtype,
                name="blocks",
            )((x, edge_attr), edge_index)
            return x, edge_attr
        for i in range(self.num_layers):
            x, edge_attr = GraphTransformerProcessorBlock(
                in_channels=self.num_channels,
                hidden_dim=self.mlp_hidden_ratio * self.num_channels,
                out_channels=self.num_channels,
                num_heads=self.num_heads,
                activation=self.activation,
                kv_src_gather=self.kv_src_gather,
                dtype=self.dtype,
                name=f"blocks_{i}",
            )(x, edge_attr, edge_index, None, self.deterministic, tables)
        return x, edge_attr
