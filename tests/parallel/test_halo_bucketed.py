"""Degree-bucketed halo GraphConv tables for skewed graphs.

The flat ``HaloGNNTables`` pad every destination/source to the worst
per-shard multiplicity; with a hub node (degree ~N over a mean of ~3) that
padding is ruinous and round 2 fell back to segment ops (scatters in the
backward). ``HaloBucketedTables`` keep per-bucket caps instead — these tests
pin numerics against the segment path and assert the whole conv still
compiles scatter-free, forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.graphs.partition import (
    HaloBucketedTables,
    build_halo_bucketed_tables,
    partition_1hop,
)
from anemoi_models_tpu.ops.segment import segment_sum
from anemoi_models_tpu.parallel import make_mesh
from anemoi_models_tpu.parallel.halo_conv import (
    apply_edge_mlp,
    graph_conv_params,
    halo_graph_conv,
    shard_edge_values,
)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")


def _skewed_graph(n=48, hub=0):
    """Ring edges plus every node feeding one hub: max in-degree ~n over a
    mean of ~3 — the layout the flat padded tables cannot afford."""
    src, dst = [], []
    for i in range(n):
        src += [i, i]
        dst += [(i + 1) % n, (i - 1) % n]
        if i != hub:
            src.append(i)
            dst.append(hub)
    edge_index = np.asarray([src, dst], dtype=np.int64)
    order = np.argsort(edge_index[1], kind="stable")
    return edge_index[:, order], n


def _setup(batch=2, C=8, shards=8):
    edge_index, n = _skewed_graph()
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(batch, n, C), jnp.float32)
    e_global = jnp.asarray(rng.randn(edge_index.shape[1], C), jnp.float32)
    params = graph_conv_params(jax.random.key(0), C, C)
    part = partition_1hop(edge_index, n, shards)
    tables = build_halo_bucketed_tables(part)
    return edge_index, n, x, e_global, params, part, tables


def _global_reference(edge_index, n, x, e_global, params):
    src, dst = jnp.asarray(edge_index)
    x_i = jnp.take(x, dst, axis=1)
    x_j = jnp.take(x, src, axis=1)
    e = jnp.broadcast_to(e_global[None], x_i.shape)
    msg = apply_edge_mlp(params, jnp.concatenate([x_i, x_j, e], -1)) + e
    return segment_sum(msg, dst, n)


def test_bucketed_tables_shapes_and_selection():
    edge_index, n, *_rest, part, tables = _setup()
    assert isinstance(tables, HaloBucketedTables)
    # bucket caps stay near the mean except for the hub's own bucket
    caps = [m.shape[2] for _, m in tables.dst_buckets]
    assert min(caps) <= 8, f"small-degree rows must land in small buckets: {caps}"
    # every live edge position has a destination and reassemble covers rows
    assert tables.pos_dst.shape == part.edge_mask.shape
    assert tables.dst_reassemble.shape == (part.num_shards, part.nodes_per_shard)


def test_bucketed_halo_conv_matches_segment_path():
    edge_index, n, x, e_global, params, part, tables = _setup()
    ref = _global_reference(edge_index, n, x, e_global, params)
    e_sharded = shard_edge_values(e_global, part)
    mesh = make_mesh(data=1, model=8)

    out_seg, _ = jax.jit(lambda x, e, p: halo_graph_conv(mesh, part, p, x, e))(
        x, e_sharded, params
    )
    out_bkt, edges_new = jax.jit(
        lambda x, e, p: halo_graph_conv(mesh, part, p, x, e, tables=tables)
    )(x, e_sharded, params)
    np.testing.assert_allclose(np.asarray(out_seg), np.asarray(ref), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out_bkt), np.asarray(ref), atol=2e-4, rtol=1e-3)
    assert edges_new.shape[0] == 8 and edges_new.ndim == 4


def test_bucketed_halo_conv_grads_match_segment_path():
    edge_index, n, x, e_global, params, part, tables = _setup(batch=1, C=4)
    e_sharded = shard_edge_values(e_global, part)
    mesh = make_mesh(data=1, model=8)

    def loss(p, xx, tabs):
        out, _ = halo_graph_conv(mesh, part, p, xx, e_sharded, tables=tabs)
        return jnp.sum(out**2)

    g_seg = jax.jit(jax.grad(loss, argnums=(0, 1)), static_argnums=2)(params, x, None)
    g_bkt = jax.jit(jax.grad(loss, argnums=(0, 1)), static_argnums=2)(params, x, tables)
    for a, b in zip(jax.tree_util.tree_leaves(g_seg), jax.tree_util.tree_leaves(g_bkt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4, rtol=1e-3)
    assert float(jnp.abs(g_bkt[1]).max()) > 0


def test_bucketed_halo_conv_is_scatter_free():
    edge_index, n, x, e_global, params, part, tables = _setup(batch=1, C=4)
    e_sharded = shard_edge_values(e_global, part)
    mesh = make_mesh(data=1, model=8)

    def loss(p, xx):
        out, _ = halo_graph_conv(mesh, part, p, xx, e_sharded, tables=tables)
        return jnp.sum(out**2)

    compiled = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(params, x).compile()
    gp, gx = compiled(params, x)
    assert jnp.isfinite(gx).all()
    bad = [
        ln
        for ln in compiled.as_text().splitlines()
        if "scatter(" in ln and "reduce-scatter" not in ln and "reduce_scatter" not in ln
    ]
    assert not bad, f"bucketed halo conv must be scatter-free fwd+bwd: {bad[:3]}"


def test_skew_guard_selects_bucketed_tables():
    """_halo_gnn_layout routes skewed graphs to the bucketed layout instead
    of dropping to segment ops."""
    from anemoi_models_tpu.graphs.container import EdgeSet
    from anemoi_models_tpu.layers.processor import _halo_gnn_layout

    edge_index, n = _skewed_graph()
    es = EdgeSet(
        edge_index=edge_index,
        attrs={"edge_length": np.random.RandomState(3).rand(edge_index.shape[1], 1)},
    )
    part, tables = _halo_gnn_layout(es, n, 8)
    assert isinstance(tables, HaloBucketedTables)


def test_gnn_processor_on_skewed_graph_matches_single_device():
    """Full config-selected path: a GNNProcessor whose sub_graph is skewed
    routes (under a model-axis mesh) to halo execution over the bucketed
    layout and matches the single-device forward."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anemoi_models_tpu.graphs.container import EdgeSet
    from anemoi_models_tpu.layers.processor import GNNProcessor
    from anemoi_models_tpu.parallel import use_mesh

    edge_index, n = _skewed_graph()
    rng = np.random.RandomState(4)
    es = EdgeSet(
        edge_index=edge_index,
        attrs={
            "edge_length": rng.rand(edge_index.shape[1], 1),
            "edge_dirs": rng.rand(edge_index.shape[1], 2),
        },
    )
    ch = 16
    proc = GNNProcessor(
        num_layers=2, num_chunks=1, num_channels=ch, trainable_size=2, sub_graph=es
    )
    x = jnp.asarray(np.random.RandomState(5).randn(1, n, ch), jnp.float32)
    params = jax.jit(proc.init)(jax.random.key(0), x)
    ref = jax.jit(proc.apply)(params, x)

    mesh = make_mesh(data=1, model=8)
    with use_mesh(mesh):
        xs = jax.device_put(x, NamedSharding(mesh, P()))
        ps = jax.device_put(params, NamedSharding(mesh, P()))
        out = jax.jit(proc.apply)(ps, xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-4, rtol=1e-3)
