import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_hierarchical_graph
from anemoi_models_tpu.models import AnemoiModelEncProcDecHierarchical
from helpers_models import VARS, make_config


@pytest.fixture(scope="module")
def hier_graph():
    return build_hierarchical_graph(grid_lat=6, mesh_refinements=2, num_levels=2)


def make_hier_config(hidden_names, level_process=True):
    cfg = make_config("graphtransformer", num_channels=8)
    cfg.graph.hidden = list(hidden_names)
    cfg.model.model._target_ = "anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical"
    cfg.model.enable_hierarchical_level_processing = level_process
    cfg.model.level_process_num_layers = 2
    return cfg


@pytest.mark.parametrize("level_process", [True, False])
def test_hierarchical_forward(hier_graph, level_process):
    graph, hidden_names = hier_graph
    cfg = make_hier_config(hidden_names, level_process)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDecHierarchical(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    n_in = len(di.internal_model.input)
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, n_in), jnp.float32)
    params = model.init(jax.random.key(0), x)
    out = model.apply(params, x)
    assert out.shape == (1, 1, n_grid, len(di.internal_model.output))
    assert jnp.isfinite(out).all()
    # level processors present only when enabled
    has_levels = any("level_processor" in k for k in params["params"])
    assert has_levels == level_process


def test_hierarchical_grads(hier_graph):
    graph, hidden_names = hier_graph
    cfg = make_hier_config(hidden_names)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDecHierarchical(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4), jnp.float32)
    params = model.init(jax.random.key(0), x)

    grads = jax.grad(lambda p: jnp.mean(model.apply(p, x) ** 2))(params)
    for kp, g in jax.tree_util.tree_leaves_with_path(grads):
        assert jnp.isfinite(g).all(), f"non-finite grad at {kp}"
