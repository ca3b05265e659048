"""Destination-sharded mapper attention (parallel/mapper_conv.py).

Under a >1 ``model`` mesh axis the GraphTransformer mappers route to
per-shard slot tables with one narrow-source all-gather — the bipartite
counterpart of the processor's halo exchange, replacing GSPMD's involuntary
full rematerializations on the mapper dataflow (reference model sharding:
``/root/reference/src/anemoi/models/distributed/graph.py:140-298``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.layers.mapper import (
    GraphTransformerBackwardMapper,
    GraphTransformerForwardMapper,
)
from anemoi_models_tpu.parallel import make_mesh, use_mesh
from helpers_models import flatten_dict, unflatten_dict


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=12, mesh_refinements=2)


def _largest_collective(hlo: str, kinds=("all-gather",)) -> dict:
    pat = re.compile(r"=\s+(?:\()?[a-z0-9]+\[([0-9,]*)\]")
    biggest = {}
    for line in hlo.splitlines():
        for kind in kinds:
            if f" {kind}(" in line or f" {kind}-start(" in line:
                m = pat.search(line)
                if m:
                    dims = [int(x) for x in m.group(1).split(",") if x]
                    biggest[kind] = max(biggest.get(kind, 0), int(np.prod(dims)) if dims else 1)
    return biggest


@pytest.mark.parametrize("num_chunks", [1, 3])
def test_forward_mapper_sharded_matches_unsharded(graph, num_chunks):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x = (
        jnp.asarray(np.random.RandomState(0).randn(1, ng, 10), jnp.float32),
        jnp.asarray(np.random.RandomState(1).randn(1, nm, 12), jnp.float32),
    )
    kw = dict(in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4,
              num_chunks=num_chunks, sub_graph=es)
    mapper = GraphTransformerForwardMapper(kv_src_gather="narrow", **kw)

    params = mapper.init(jax.random.key(0), x)
    out_ref = mapper.apply(params, x)[1]

    mesh = make_mesh(data=1, model=8)
    with use_mesh(mesh):
        compiled = jax.jit(mapper.apply).lower(params, x).compile()
        out_sh = compiled(params, x)[1]
    np.testing.assert_allclose(np.asarray(out_sh), np.asarray(out_ref), rtol=2e-5, atol=2e-5)

    # the only all-gather is the narrow source rows (width 10), never k/v
    biggest = _largest_collective(compiled.as_text())
    assert biggest.get("all-gather", 0) <= (ng + 8) * 10, biggest


def test_forward_mapper_sharded_grads_match(graph):
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x = (
        jnp.asarray(np.random.RandomState(2).randn(1, ng, 10), jnp.float32),
        jnp.asarray(np.random.RandomState(3).randn(1, nm, 12), jnp.float32),
    )
    kw = dict(in_channels_src=10, in_channels_dst=12, hidden_dim=32, num_heads=4, sub_graph=es)
    mapper = GraphTransformerForwardMapper(kv_src_gather="narrow", **kw)
    params = mapper.init(jax.random.key(0), x)

    def loss(p):
        return (mapper.apply(p, x)[1] ** 2).sum()

    g_ref = flatten_dict(jax.grad(loss)(params)["params"])
    mesh = make_mesh(data=1, model=8)
    with use_mesh(mesh):
        g_sh = flatten_dict(jax.jit(jax.grad(loss))(params)["params"])
    assert set(g_ref) == set(g_sh)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_ref[k]), rtol=5e-4, atol=5e-4,
            err_msg=str(k),
        )


def test_backward_mapper_sharded_matches_unsharded(graph):
    es = graph[("hidden", "to", "data")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x = (
        jnp.asarray(np.random.RandomState(4).randn(1, nm, 32), jnp.float32),
        jnp.asarray(np.random.RandomState(5).randn(1, ng, 12), jnp.float32),
    )
    kw = dict(
        in_channels_src=32, in_channels_dst=12, hidden_dim=32, num_heads=4,
        out_channels_dst=7, sub_graph=es,
    )
    mapper = GraphTransformerBackwardMapper(kv_src_gather="narrow", **kw)
    params = mapper.init(jax.random.key(0), x)
    out_ref = mapper.apply(params, x)

    mesh = make_mesh(data=1, model=8)
    with use_mesh(mesh):
        out_sh = jax.jit(mapper.apply)(params, x)
    np.testing.assert_allclose(np.asarray(out_sh), np.asarray(out_ref), rtol=2e-5, atol=2e-5)


def test_sharded_tables_only_under_model_axis(graph):
    """Without a mesh (or with model=1) the mapper keeps the dense tables."""
    from anemoi_models_tpu.graphs.partition import MapperShardTables, mapper_shard_tables

    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    st = mapper_shard_tables(es, nm, ng, 8)
    assert isinstance(st, MapperShardTables)
    assert st.src_ids.shape[0] == 8
    # every edge occupies exactly one slot
    assert int(st.mask.sum()) == es.num_edges
    assert (st.pos_of_edge >= 0).all()
    # slot table round-trip: slot src ids match the edge list
    src, dst = np.asarray(es.edge_index)
    flat_src = st.src_ids.reshape(-1)[st.pos_of_edge]
    np.testing.assert_array_equal(flat_src, src)
