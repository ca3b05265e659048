"""Checks that run on the card only (marker ``gpu``): the GPU attention
route and the dense graph path against their plain references, compiled
for the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_gpu_attention_route_matches_reference(gpu):
    from anemoi_models_tpu.ops.attention import (
        _reference_attention,
        dot_product_attention,
        resolve_attention_impl,
    )

    assert resolve_attention_impl("auto") == "chunked"
    rs = np.random.RandomState(0)
    q, k, v = (jnp.asarray(rs.randn(1, 4, 3000, 16), jnp.bfloat16) for _ in range(3))
    out = jax.jit(lambda q, k, v: dot_product_attention(q, k, v, window_size=256))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = _reference_attention(*(t.astype(jnp.float32) for t in (q, k, v)), 256, False)
    bound = 2.0**-7 * float(jnp.abs(ref).max())  # four bf16 roundings at the largest value
    assert float(jnp.abs(out.astype(jnp.float32) - ref).max()) <= bound


def test_gpu_dense_matches_segment(gpu, small_graph):
    from anemoi_models_tpu.checkpoint import _migrate_restore
    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.models import AnemoiModelEncProcDec

    from helpers_models import VARS, make_config

    models = {}
    for impl in ("dense", "segment"):
        cfg = make_config("graphtransformer")
        cfg.model.processor.graph_impl = cfg.model.encoder.graph_impl = impl
        cfg.model.decoder.graph_impl = impl
        di = IndexCollection(cfg, dict(VARS))
        models[impl] = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=small_graph)
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4), jnp.float32)
    key = jax.random.key(0)
    with jax.default_matmul_precision("highest"):
        p = jax.jit(models["dense"].init)(key, x)
        p_seg = _migrate_restore(p, jax.eval_shape(models["segment"].init, key, x))
        a = jax.jit(models["dense"].apply)(p, x)
        b = jax.jit(models["segment"].apply)(p_seg, x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5)
