"""Narrow-source mapper gathers: gather raw rows once, project k/v after.

Per-row ops (embed, LayerNorm, k/v projection) commute with row gathers, so
the narrow dataflow must match the wide (reference) dataflow exactly in
forward and to fp32 tolerance in grads, while keeping the compiled backward
scatter-free (the gather adjoint rides the build-time transpose tables).
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
from helpers_models import flatten_dict, unflatten_dict


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=8, grid="latlon", mesh_refinements=2)


def _wide_to_narrow(pw):
    """Map the wide param tree onto the narrow layout (emb_nodes_src moves
    into the block scope)."""
    flat = flatten_dict(pw["params"])
    remap = {
        (("proc", "emb_nodes_src") + k[1:] if k[0] == "emb_nodes_src" else k): v
        for k, v in flat.items()
    }
    return {"params": unflatten_dict(remap)}


def test_forward_mapper_narrow_matches_wide(graph):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(0).randn(1, ng, 10), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(1).randn(1, nm, 12), jnp.float32)
    kw = dict(in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4, sub_graph=es)
    wide = GraphTransformerForwardMapper(kv_src_gather="wide", **kw)
    narrow = GraphTransformerForwardMapper(kv_src_gather="narrow", **kw)

    pw = wide.init(jax.random.key(0), (x_src, x_dst))
    pn = _wide_to_narrow(pw)
    out_w = wide.apply(pw, (x_src, x_dst))[1]
    out_n = narrow.apply(pn, (x_src, x_dst))[1]
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_n), rtol=2e-6, atol=2e-6)

    def loss(m, p):
        return (m.apply(p, (x_src, x_dst))[1] ** 2).sum()

    gw = flatten_dict(jax.grad(lambda p: loss(wide, p))(pw)["params"])
    gn = flatten_dict(jax.grad(lambda p: loss(narrow, p))(pn)["params"])
    for k, v in gn.items():
        wk = ("emb_nodes_src",) + k[2:] if k[:2] == ("proc", "emb_nodes_src") else k
        np.testing.assert_allclose(np.asarray(v), np.asarray(gw[wk]), rtol=5e-4, atol=5e-5)


def test_backward_mapper_narrow_matches_wide(graph):
    es = graph[("hidden", "to", "data")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(2).randn(1, nm, 32), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(3).randn(1, ng, 12), jnp.float32)
    kw = dict(
        in_channels_src=32, in_channels_dst=12, hidden_dim=32, num_heads=4,
        out_channels_dst=7, sub_graph=es,
    )
    wide = GraphTransformerBackwardMapper(kv_src_gather="wide", **kw)
    narrow = GraphTransformerBackwardMapper(kv_src_gather="narrow", **kw)
    # no src embedding in the backward mapper: param trees are identical
    p = wide.init(jax.random.key(0), (x_src, x_dst))
    out_w = wide.apply(p, (x_src, x_dst))
    out_n = narrow.apply(p, (x_src, x_dst))
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_n), rtol=2e-6, atol=2e-6)


def test_narrow_backward_is_scatter_free(graph):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x_src = jnp.asarray(np.random.RandomState(4).randn(1, ng, 10), jnp.float32)
    x_dst = jnp.asarray(np.random.RandomState(5).randn(1, nm, 12), jnp.float32)
    narrow = GraphTransformerForwardMapper(
        in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4,
        sub_graph=es, kv_src_gather="narrow",
    )
    p = narrow.init(jax.random.key(0), (x_src, x_dst))

    def loss(p):
        return (narrow.apply(p, (x_src, x_dst))[1] ** 2).sum()

    text = jax.jit(jax.grad(loss)).lower(p).compile().as_text()
    assert "scatter(" not in text, "narrow-gather backward must be scatter-free"
