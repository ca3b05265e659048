"""Device-side 1-hop halo exchange over the model axis (shard_map).

The sharded alternative to the reference's full all-gather of node
features before each GNN layer (``sync_tensor``, ``distributed/graph.py:
92-113`` used at ``layers/block.py:203``): node rows are contiguously sharded
over the ``model`` mesh axis, and each layer exchanges only the *boundary
pool* — the union of 1-hop ghost nodes — via one tiled all-gather whose
payload is O(boundary), not O(nodes). The plan (which rows to contribute,
which pool entries form each shard's halo, the locally-remapped edge lists)
is precomputed on host by :func:`anemoi_models_tpu.graphs.partition.
partition_1hop`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from anemoi_models_tpu.graphs.partition import HaloPartition

__all__ = ["pad_nodes", "unpad_nodes", "halo_apply"]


def pad_nodes(x: jnp.ndarray, part: HaloPartition) -> jnp.ndarray:
    """Pad the node axis (-2) to num_shards * nodes_per_shard rows."""
    total = part.num_shards * part.nodes_per_shard
    pad = total - x.shape[-2]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[-2] = (0, pad)
    return jnp.pad(x, widths)


def unpad_nodes(x: jnp.ndarray, part: HaloPartition) -> jnp.ndarray:
    """Drop node-axis padding rows."""
    return x[..., : part.num_nodes, :]


def halo_apply(
    mesh: Mesh,
    part: HaloPartition,
    fn: Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], jnp.ndarray],
    x: jnp.ndarray,
    axis: str = "model",
) -> jnp.ndarray:
    """Run ``fn`` per shard on halo-extended features.

    ``x``: (batch, S * nodes_per_shard, C) — use :func:`pad_nodes` first.
    ``fn(x_ext, local_edges, edge_mask) -> (batch, nodes_per_shard, C_out)``
    runs inside ``shard_map``; ``x_ext`` is (batch, nodes_per_shard + H_pad, C)
    = [owned rows | halo rows], ``local_edges`` (E_pad, 2) = [src_ext,
    dst_local], ``edge_mask`` (E_pad,).
    """
    bc = jnp.asarray(part.boundary_contrib)
    hs = jnp.asarray(part.halo_select)
    hm = jnp.asarray(part.halo_mask)
    le = jnp.asarray(part.local_edges)
    em = jnp.asarray(part.edge_mask)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None),
            P(axis, None, None),
            P(axis, None),
        ),
        out_specs=P(None, axis, None),
    )
    def run(x_blk, bc_blk, hs_blk, hm_blk, le_blk, em_blk):
        # x_blk: (B, nps, C); *_blk carry this shard's plan row
        contrib = jnp.take(x_blk, bc_blk[0], axis=1)  # (B, B_pad, C)
        pool = jax.lax.all_gather(contrib, axis, axis=1, tiled=True)  # (B, S*B_pad, C)
        halo = jnp.take(pool, hs_blk[0], axis=1) * hm_blk[0][None, :, None].astype(x_blk.dtype)
        x_ext = jnp.concatenate([x_blk, halo], axis=1)
        return fn(x_ext, le_blk[0], em_blk[0])

    return run(x, bc, hs, hm, le, em)
