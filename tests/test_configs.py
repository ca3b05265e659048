"""The config presets build working models for every flavor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu import configs
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph, build_hierarchical_graph
from anemoi_models_tpu.models import (
    AnemoiModelEncProcDec,
    AnemoiModelEncProcDecHierarchical,
)

VARS = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}


@pytest.mark.parametrize("flavor", configs.FLAVORS)
def test_enc_proc_dec_preset_builds_and_runs(flavor):
    cfg = configs.enc_proc_dec(
        forcing=["lsm"], diagnostic=["tp"], flavor=flavor,
        num_channels=16, num_layers=2, num_chunks=1, num_heads=4,
        window_size=8, compute_dtype="float32",
    )
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    x = jnp.asarray(
        np.random.RandomState(0).randn(1, 2, 1, n_grid, len(di.internal_model.input)),
        jnp.float32,
    )
    params = jax.jit(model.init)(jax.random.key(0), x)
    out = jax.jit(model.apply)(params, x)
    assert out.shape == (1, 1, n_grid, len(di.internal_model.output))
    assert jnp.isfinite(out).all()


def test_hierarchical_preset_builds_and_runs():
    graph, hidden_names = build_hierarchical_graph(
        grid_lat=6, mesh_refinements=2, num_levels=2
    )
    cfg = configs.hierarchical(
        forcing=["lsm"], diagnostic=["tp"], hidden_names=hidden_names,
        num_channels=8, num_layers=2, num_chunks=1, num_heads=4,
        compute_dtype="float32",
    )
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDecHierarchical(
        model_config=cfg, data_indices=di, graph_data=graph
    )
    n_grid = graph["data"].num_nodes
    x = jnp.asarray(
        np.random.RandomState(0).randn(1, 2, 1, n_grid, len(di.internal_model.input)),
        jnp.float32,
    )
    params = jax.jit(model.init)(jax.random.key(0), x)
    out = jax.jit(model.apply)(params, x)
    assert out.shape == (1, 1, n_grid, len(di.internal_model.output))
    assert jnp.isfinite(out).all()


def test_preset_with_bounding_and_kernel_impl():
    cfg = configs.enc_proc_dec(
        forcing=["lsm"], diagnostic=["tp"], num_channels=16, num_layers=2,
        num_chunks=1, num_heads=4, graph_impl="segment", compute_dtype="float32",
        bounding=[{
            "_target_": "anemoi.models.layers.bounding.ReluBounding",
            "variables": ["tp"],
        }],
    )
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    x = jnp.asarray(
        np.random.RandomState(0).randn(1, 2, 1, n_grid, len(di.internal_model.input)),
        jnp.float32,
    )
    params = jax.jit(model.init)(jax.random.key(0), x)
    out = jax.jit(model.apply)(params, x)
    tp = di.internal_model.output.name_to_index["tp"]
    assert (out[..., tp] >= 0).all()
