"""Rollout precision discipline: bf16 compute must track fp32 over a
multi-step autoregressive rollout (SURVEY.md hard part #3 — fp32 accumulation
in softmax/LayerNorm keeps bf16 rollouts comparable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.models import AnemoiModelEncProcDec
from anemoi_models_tpu.training import make_rollout_fn
from helpers_models import VARS, make_config


def build(small_graph, dtype, graph_impl=None):
    cfg = make_config("graphtransformer", num_channels=16)
    cfg.model.compute_dtype = dtype
    if graph_impl:
        cfg.model.processor.graph_impl = graph_impl
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(
        model_config=cfg,
        data_indices=di,
        graph_data=small_graph,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
    )
    return di, model


@pytest.mark.parametrize("graph_impl", [None, "segment"])
def test_bf16_rollout_tracks_fp32(small_graph, graph_impl):
    di32, m32 = build(small_graph, "float32")
    _, m16 = build(small_graph, "bfloat16", graph_impl=graph_impl)
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4) * 0.5, jnp.float32)
    params = m32.init(jax.random.key(0), x)

    n_steps = 6
    roll32 = jax.jit(make_rollout_fn(m32, di32, n_steps))
    roll16 = jax.jit(make_rollout_fn(m16, di32, n_steps))
    forcings = jnp.zeros((n_steps, 1, 1, n_grid, 1), jnp.float32)
    _, p32 = roll32(params, x, forcings)
    _, p16 = roll16(params, x, forcings)

    assert jnp.isfinite(p16).all()
    # relative drift of the bf16 rollout stays bounded at every step
    for step in range(n_steps):
        denom = float(jnp.abs(p32[step]).mean()) + 1e-6
        drift = float(jnp.abs(p32[step] - p16[step]).mean()) / denom
        assert drift < 0.15, f"bf16 rollout diverged at step {step}: drift={drift:.3f}"
