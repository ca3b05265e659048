"""Commuted-projection edge attention: zero matmuls on the padded slot axis.

With ``k_j = W_k f_j + b_k + W_e e_j + b_e`` the logits satisfy
``q·k_j = (W_kᵀq)·f_j + (W_eᵀq)·e_j + const(j)`` and the softmax is
shift-invariant in the constant; on the value side the α-weighted sum
commutes with the linear maps. So the commuted dataflow
(``ops/dense_graph.commuted_edge_attention``) must match the wide
(reference) dataflow to fp reassociation tolerance in both values and
grads, with identical parameter trees (the fused kernels are probed, not
split), and keep the compiled backward scatter-free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.layers.mapper import (
    GraphTransformerBackwardMapper,
    GraphTransformerForwardMapper,
)
from anemoi_models_tpu.layers.processor import GraphTransformerProcessor
from helpers_models import flatten_dict, unflatten_dict


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=8, grid="latlon", mesh_refinements=2)


def _wide_to_narrow(pw):
    """emb_nodes_src moves into the block scope under narrow/commute."""
    flat = flatten_dict(pw["params"])
    remap = {
        (("proc", "emb_nodes_src") + k[1:] if k[0] == "emb_nodes_src" else k): v
        for k, v in flat.items()
    }
    return {"params": unflatten_dict(remap)}


def test_forward_mapper_commute_matches_wide(graph):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(0).randn(1, ng, 10), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(1).randn(1, nm, 12), jnp.float32)
    kw = dict(in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4, sub_graph=es)
    wide = GraphTransformerForwardMapper(kv_src_gather="wide", **kw)
    comm = GraphTransformerForwardMapper(kv_src_gather="commute", **kw)

    pw = wide.init(jax.random.key(0), (x_src, x_dst))
    pc = _wide_to_narrow(pw)
    out_w = wide.apply(pw, (x_src, x_dst))[1]
    out_c = comm.apply(pc, (x_src, x_dst))[1]
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_c), rtol=2e-5, atol=2e-5)

    def loss(m, p):
        return (m.apply(p, (x_src, x_dst))[1] ** 2).sum()

    gw = flatten_dict(jax.grad(lambda p: loss(wide, p))(pw)["params"])
    gc = flatten_dict(jax.grad(lambda p: loss(comm, p))(pc)["params"])
    for k, v in gc.items():
        wk = ("emb_nodes_src",) + k[2:] if k[:2] == ("proc", "emb_nodes_src") else k
        np.testing.assert_allclose(np.asarray(v), np.asarray(gw[wk]), rtol=5e-4, atol=5e-4)


def test_backward_mapper_commute_matches_wide(graph):
    es = graph[("hidden", "to", "data")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(2).randn(1, nm, 32), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(3).randn(1, ng, 12), jnp.float32)
    kw = dict(
        in_channels_src=32, in_channels_dst=12, hidden_dim=32, num_heads=4,
        out_channels_dst=7, sub_graph=es,
    )
    wide = GraphTransformerBackwardMapper(kv_src_gather="wide", **kw)
    comm = GraphTransformerBackwardMapper(kv_src_gather="commute", **kw)
    # no src embedding in the backward mapper: param trees are identical
    p = wide.init(jax.random.key(0), (x_src, x_dst))
    out_w = wide.apply(p, (x_src, x_dst))
    out_c = comm.apply(p, (x_src, x_dst))
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_c), rtol=2e-5, atol=2e-5)

    def loss(m, pp):
        return (m.apply(pp, (x_src, x_dst)) ** 2).sum()

    gw = flatten_dict(jax.grad(lambda pp: loss(wide, pp))(p)["params"])
    gc = flatten_dict(jax.grad(lambda pp: loss(comm, pp))(p)["params"])
    for k, v in gc.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(gw[k]), rtol=5e-4, atol=5e-4)


def test_processor_commute_matches_wide(graph):
    es = graph[("hidden", "to", "hidden")]
    nm = graph["hidden"].num_nodes
    x = jnp.asarray(np.random.RandomState(4).randn(1, nm, 32), jnp.float32)
    kw = dict(num_layers=2, num_channels=32, num_chunks=1, num_heads=4, sub_graph=es)
    wide = GraphTransformerProcessor(kv_src_gather="wide", **kw)
    comm = GraphTransformerProcessor(kv_src_gather="commute", **kw)
    # identical parameter trees: the fused lin_qkvs kernel is probed, not split
    p = wide.init(jax.random.key(0), x)
    assert jax.tree_util.tree_structure(p) == jax.tree_util.tree_structure(
        comm.init(jax.random.key(0), x)
    )
    out_w = wide.apply(p, x)
    out_c = comm.apply(p, x)
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_c), rtol=2e-5, atol=2e-5)

    def loss(m, pp):
        return (m.apply(pp, x) ** 2).sum()

    gw = flatten_dict(jax.grad(lambda pp: loss(wide, pp))(p)["params"])
    gc = flatten_dict(jax.grad(lambda pp: loss(comm, pp))(p)["params"])
    for k, v in gc.items():
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(gw[k]), rtol=1e-3, atol=5e-4, err_msg=str(k)
        )


def test_commute_backward_is_scatter_free(graph):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(5).randn(1, ng, 10), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(6).randn(1, nm, 12), jnp.float32)
    comm = GraphTransformerForwardMapper(
        in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4,
        sub_graph=es, kv_src_gather="commute",
    )
    p = comm.init(jax.random.key(0), (x_src, x_dst))

    def loss(p):
        return (comm.apply(p, (x_src, x_dst))[1] ** 2).sum()

    text = jax.jit(jax.grad(loss)).lower(p).compile().as_text()
    assert "scatter(" not in text, "commuted backward must be scatter-free"

def test_mapper_block_commute_probes_embed_width(graph):
    """src_embed_dim != in_channels: lin_kv consumes the embedded rows, so
    the probe must use the embed width — a mismatch would create a
    wrongly-shaped lin_kv kernel at init (checkpoint-incompatible) or fail
    at the einsum (advisor round-3 finding)."""
    from anemoi_models_tpu.graphs.partition import edge_set_gather_tables
    from anemoi_models_tpu.layers.block import GraphTransformerMapperBlock
    from anemoi_models_tpu.ops.dense_graph import GatherTables, TransposeBundle

    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(7).randn(1, ng, 10), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(8).randn(1, nm, 16), jnp.float32)
    e = jnp.asarray(np.random.RandomState(12).randn(1, es.num_edges, 3), jnp.float32)
    ei = jnp.asarray(es.edge_index)
    buckets, reassemble, bundle = edge_set_gather_tables(es, nm, ng)
    tables = GatherTables(buckets, reassemble, TransposeBundle(bundle))
    kw = dict(in_channels=16, hidden_dim=32, out_channels=16, num_heads=4, src_embed_dim=24)
    wide = GraphTransformerMapperBlock(kv_src_gather="wide", **kw)
    comm = GraphTransformerMapperBlock(kv_src_gather="commute", **kw)
    p = wide.init(jax.random.key(0), (x_src, x_dst), e, ei, nm, True, tables)
    # identical trees: the probe materializes lin_kv at the true (24) fan-in
    assert jax.tree_util.tree_structure(p) == jax.tree_util.tree_structure(
        comm.init(jax.random.key(0), (x_src, x_dst), e, ei, nm, True, tables)
    )
    (_, out_w), _ = wide.apply(p, (x_src, x_dst), e, ei, nm, True, tables)
    (_, out_c), _ = comm.apply(p, (x_src, x_dst), e, ei, nm, True, tables)
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_c), rtol=2e-5, atol=2e-5)


def test_processor_commute_matches_wide_bf16(graph):
    """bf16 probe tolerance: W is recovered as (W+b)-b in bf16, adding a
    ~eps_bf16*|b| perturbation on top of reassociation (documented in
    _probe_affine) — the paths must still agree at bf16 tolerances."""
    es = graph[("hidden", "to", "hidden")]
    nm = graph["hidden"].num_nodes
    x = jnp.asarray(np.random.RandomState(9).randn(1, nm, 32), jnp.bfloat16)
    kw = dict(
        num_layers=2, num_channels=32, num_chunks=1, num_heads=4, sub_graph=es,
        dtype=jnp.bfloat16,
    )
    wide = GraphTransformerProcessor(kv_src_gather="wide", **kw)
    comm = GraphTransformerProcessor(kv_src_gather="commute", **kw)
    p = wide.init(jax.random.key(0), x)
    out_w = np.asarray(wide.apply(p, x), np.float32)
    out_c = np.asarray(comm.apply(p, x), np.float32)
    scale = np.abs(out_w).max()
    np.testing.assert_allclose(out_w, out_c, atol=0.05 * scale)


def test_processor_explicit_commute_warns_without_tables(graph):
    """An explicit 'commute'/'narrow' the processor cannot honor must warn
    (mirror of the mapper's behavior); 'auto' stays silent."""
    import warnings

    from anemoi_models_tpu.layers.block import GraphTransformerProcessorBlock

    es = graph[("hidden", "to", "hidden")]
    nm = graph["hidden"].num_nodes
    x = jnp.asarray(np.random.RandomState(10).randn(1, nm, 32), jnp.float32)
    e = jnp.asarray(np.random.RandomState(11).randn(1, es.num_edges, 3), jnp.float32)
    ei = jnp.asarray(es.edge_index)
    kw = dict(in_channels=32, hidden_dim=64, out_channels=32, num_heads=4)

    for mode in ("commute", "narrow"):
        block = GraphTransformerProcessorBlock(kv_src_gather=mode, **kw)
        with pytest.warns(UserWarning, match="cannot be honored"):
            block.init(jax.random.key(0), x, e, ei)  # tables=None
    block = GraphTransformerProcessorBlock(kv_src_gather="auto", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        block.init(jax.random.key(0), x, e, ei)
