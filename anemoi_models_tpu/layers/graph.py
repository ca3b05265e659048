"""Node-attribute layers: trainable per-node embeddings + sin/cos coords.

Counterpart of reference ``layers/graph.py:18-113``. Design difference: the
batch dimension is explicit — features are (batch, nodes, feat) and the
trainable tensor broadcasts over batch instead of the reference's
``einops.repeat`` flattening (``layers/graph.py:38-40``), which keeps the
node axis shardable on the device mesh.
"""

from __future__ import annotations

from anemoi_models_tpu import nn
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.graphs.container import HeteroGraph

__all__ = ["TrainableTensor", "NamedNodesAttributes"]


class TrainableTensor(nn.Module):
    """Concatenate a zero-initialized trainable per-row embedding to x.

    ``x``: (batch, rows, feat) or (rows, feat); output gains
    ``trainable_size`` features and an explicit batch dim.
    """

    tensor_size: int
    trainable_size: int

    @nn.compact
    def __call__(self, x: jnp.ndarray, batch_size: int) -> jnp.ndarray:
        if x.ndim == 2:
            x = jnp.broadcast_to(x[None], (batch_size, *x.shape))
        parts = [x]
        if self.trainable_size > 0:
            trainable = self.param(
                "trainable", nn.initializers.zeros, (self.tensor_size, self.trainable_size), jnp.float32
            )
            parts.append(
                jnp.broadcast_to(trainable[None].astype(x.dtype), (batch_size, *trainable.shape))
            )
        return jnp.concatenate(parts, axis=-1)


class NamedNodesAttributes(nn.Module):
    """Per-node-set attributes: sin/cos of coordinates + trainable embedding.

    ``attr_ndims[name] = 2 * coord_dim + num_trainable_params`` as in the
    reference (``layers/graph.py:86-88``).
    """

    num_trainable_params: int
    graph_data: HeteroGraph

    def setup(self) -> None:
        self.num_nodes = {name: ns.num_nodes for name, ns in self.graph_data.node_items()}
        self.attr_ndims = {
            name: 2 * ns.coords.shape[1] + self.num_trainable_params
            for name, ns in self.graph_data.node_items()
        }
        self.latlons = {
            name: jnp.asarray(
                np.concatenate([np.sin(ns.coords), np.cos(ns.coords)], axis=-1), dtype=jnp.float32
            )
            for name, ns in self.graph_data.node_items()
        }
        # Params created eagerly for every node set (the reference registers a
        # TrainableTensor per set at construction, ``layers/graph.py:77-80``).
        if self.num_trainable_params > 0:
            self.trainable_tensors = {
                name: self.param(
                    f"trainable_{name}",
                    nn.initializers.zeros,
                    (n, self.num_trainable_params),
                    jnp.float32,
                )
                for name, n in self.num_nodes.items()
            }
        else:
            self.trainable_tensors = {}

    def get_coordinates(self, name: str) -> jnp.ndarray:
        sin_cos = self.latlons[name]
        ndim = sin_cos.shape[1] // 2
        return jnp.arctan2(sin_cos[:, :ndim], sin_cos[:, ndim:])

    def __call__(self, name: str, batch_size: int) -> jnp.ndarray:
        """(batch, num_nodes, attr_ndims[name]) node features."""
        x = self.latlons[name]
        x = jnp.broadcast_to(x[None], (batch_size, *x.shape))
        if name in self.trainable_tensors:
            t = self.trainable_tensors[name]
            x = jnp.concatenate(
                [x, jnp.broadcast_to(t[None].astype(x.dtype), (batch_size, *t.shape))], axis=-1
            )
        return x
