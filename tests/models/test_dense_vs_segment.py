"""The default dense graph path against the segment (COO) reference at model
level: same parameters, forward values and parameter gradients, for both
graph flavors, both compute dtypes and two batch sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.checkpoint import _migrate_restore
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.models import AnemoiModelEncProcDec

from helpers_models import VARS, make_config

# float32: the paths sum the same terms in another order; bf16: both round
# every stored activation to 8 significant bits, so they agree to a few
# bf16 roundings rather than to float32 rounding
_TOL = {
    "float32": dict(rtol=2e-4, atol=2e-5),
    "bfloat16": dict(rtol=5e-2, atol=5e-2),
}


def _model(graph, flavor, dtype, impl):
    cfg = make_config(flavor)
    cfg.model.processor.graph_impl = impl
    cfg.model.encoder.graph_impl = impl
    cfg.model.decoder.graph_impl = impl
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(
        model_config=cfg, data_indices=di, graph_data=graph,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
    )
    return model, di


@pytest.mark.parametrize("kind", ["value", "gradient"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flavor", ["graphtransformer", "gnn"])
def test_dense_matches_segment_reference(small_graph, flavor, dtype, batch, kind):
    dense, di = _model(small_graph, flavor, dtype, "dense")
    seg, _ = _model(small_graph, flavor, dtype, "segment")
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(
        np.random.RandomState(batch).randn(batch, 2, 1, n_grid, len(di.internal_model.input)),
        jnp.float32,
    )
    key = jax.random.key(0)
    p_dense = jax.jit(dense.init)(key, x)
    # the segment path may keep an embedding one scope up: same arrays, moved
    p_seg = _migrate_restore(p_dense, jax.eval_shape(seg.init, key, x))
    tol = _TOL[dtype]
    if kind == "value":
        a = np.asarray(jax.jit(dense.apply)(p_dense, x), np.float32)
        b = np.asarray(jax.jit(seg.apply)(p_seg, x), np.float32)
        assert a.shape == (batch, 1, n_grid, len(di.internal_model.output))
        np.testing.assert_allclose(a, b, **tol)
        return

    def loss(model):
        return lambda p: jnp.mean(model.apply(p, x).astype(jnp.float32) ** 2)

    g_dense = jax.jit(jax.grad(loss(dense)))(p_dense)
    g_seg = _migrate_restore(jax.jit(jax.grad(loss(seg)))(p_seg), g_dense)
    for (kp, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(g_dense), jax.tree_util.tree_leaves_with_path(g_seg)
    ):
        scale = max(float(jnp.abs(b).max()), 1e-6)
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale, err_msg=jax.tree_util.keystr(kp), **tol
        )
