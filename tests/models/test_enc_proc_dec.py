import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.interface import AnemoiModelInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec

from helpers_models import VARS, make_config, make_statistics


def build_model(small_graph, flavor):
    cfg = make_config(flavor)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=small_graph)
    n_grid = small_graph["data"].num_nodes
    n_in = len(di.internal_model.input)
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, n_in), jnp.float32)
    params = model.init(jax.random.key(0), x)
    return cfg, di, model, x, params


@pytest.mark.parametrize("flavor", ["graphtransformer", "gnn", "transformer"])
def test_enc_proc_dec_forward(small_graph, flavor):
    cfg, di, model, x, params = build_model(small_graph, flavor)
    out = model.apply(params, x)
    n_grid = small_graph["data"].num_nodes
    assert out.shape == (1, 1, n_grid, len(di.internal_model.output))
    assert jnp.isfinite(out).all()


@pytest.mark.parametrize("flavor", ["graphtransformer"])
def test_enc_proc_dec_grads(small_graph, flavor):
    _, _, model, x, params = build_model(small_graph, flavor)

    def loss(p):
        return jnp.mean(model.apply(p, x) ** 2)

    grads = jax.grad(loss)(params)
    for kp, g in jax.tree_util.tree_leaves_with_path(grads):
        assert jnp.isfinite(g).all(), f"non-finite grad at {kp}"
    # trainable node/edge embeddings must receive gradients
    flat = {jax.tree_util.keystr(kp): g for kp, g in jax.tree_util.tree_leaves_with_path(grads)}
    trainable_grads = [v for k, v in flat.items() if "trainable" in k]
    assert trainable_grads and any(float(jnp.abs(g).max()) > 0 for g in trainable_grads)


def test_residual_connection(small_graph):
    """With zero-ish network output, prognostic outputs equal last input state."""
    cfg, di, model, x, params = build_model(small_graph, "graphtransformer")[0:5]
    out = model.apply(params, x)
    prog_in = np.asarray(di.internal_model.input.prognostic)
    prog_out = np.asarray(di.internal_model.output.prognostic)
    # residual: out = net(x) + x_last for prognostic vars; with random init the
    # correlation with the input must be visible (delta smaller than raw input)
    delta = np.asarray(out[0, 0, :, prog_out[0]]) - np.asarray(x[0, -1, 0, :, prog_in[0]])
    assert np.abs(delta).mean() < np.abs(np.asarray(out[0, 0, :, prog_out[0]])).mean() + 1.0


def test_bounding_applied(small_graph):
    cfg = make_config(
        "graphtransformer",
        bounding=[
            {"_target_": "anemoi.models.layers.bounding.ReluBounding", "variables": ["tp"]}
        ],
    )
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=small_graph)
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4), jnp.float32)
    params = model.init(jax.random.key(0), x)
    out = model.apply(params, x)
    tp_idx = di.internal_model.output.name_to_index["tp"]
    assert (out[..., tp_idx] >= 0).all()


def test_interface_predict_step(small_graph):
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg,
        graph_data=small_graph,
        statistics=make_statistics(),
        data_indices=di,
        metadata={"note": "test"},
    )
    n_grid = small_graph["data"].num_nodes
    iface.init_params(jax.random.key(0))
    # inference-width batch: model input vars (lsm, z_500, t_850, t2m)
    batch = jnp.asarray(np.random.RandomState(1).rand(1, 2, n_grid, 4), jnp.float32)
    out = iface.predict_step(batch)
    # output at model-output width: z_500, t_850, t2m, tp
    assert out.shape == (1, 1, n_grid, 4)
    assert jnp.isfinite(out).all()
    # jitted path agrees with eager
    fn = iface.make_predict_fn()
    out_jit = fn(iface.params, batch)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_jit), atol=1e-5)


def test_interface_forward_equals_model_apply(small_graph):
    cfg = make_config("gnn")
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di
    )
    x = iface.example_input()
    params = iface.init_params(jax.random.key(0), x)
    np.testing.assert_array_equal(
        np.asarray(iface.forward(x)), np.asarray(iface.model.apply(params, x))
    )


def test_interface_save_load(small_graph, tmp_path):
    from helpers_models import make_statistics

    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di,
        metadata={"experiment": "save-load"},
    )
    iface.init_params(jax.random.key(0))
    n_grid = small_graph["data"].num_nodes
    batch = jnp.asarray(np.random.RandomState(2).rand(1, 2, n_grid, 4), jnp.float32)
    out_before = iface.predict_step(batch)
    path = iface.save(str(tmp_path / "ckpt"), step=3)

    iface2 = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di,
        metadata={},
    )
    restored = iface2.load(path)
    assert restored["step"] == 3
    assert iface2.id == iface.id
    out_after = iface2.predict_step(batch)
    np.testing.assert_allclose(np.asarray(out_before), np.asarray(out_after), atol=1e-6)


def test_interface_from_checkpoint(small_graph, tmp_path):
    """A saved checkpoint alone rebuilds the full serving interface."""
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di,
        metadata={"experiment": "self-contained"},
    )
    iface.init_params(jax.random.key(0))
    n_grid = small_graph["data"].num_nodes
    batch = jnp.asarray(np.random.RandomState(5).rand(1, 2, n_grid, 4), jnp.float32)
    out_before = iface.predict_step(batch)
    path = iface.save(str(tmp_path / "ckpt"), step=2)

    served = AnemoiModelInterface.from_checkpoint(path)
    assert served.id == iface.id
    assert served.metadata["experiment"] == "self-contained"
    assert served.data_indices == di
    np.testing.assert_allclose(
        np.asarray(served.predict_step(batch)), np.asarray(out_before), atol=1e-6
    )

    # graph excluded: must ask for one, and accept an externally cached one
    slim = iface.save(str(tmp_path / "slim"), step=2, include_graph=False)
    with pytest.raises(ValueError, match="include_graph=False"):
        AnemoiModelInterface.from_checkpoint(slim)
    served2 = AnemoiModelInterface.from_checkpoint(slim, graph_data=small_graph)
    np.testing.assert_allclose(
        np.asarray(served2.predict_step(batch)), np.asarray(out_before), atol=1e-6
    )


def test_ensemble_dimension(small_graph):
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=small_graph)
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(2, 2, 3, n_grid, 4), jnp.float32)
    params = model.init(jax.random.key(0), x)
    out = model.apply(params, x)
    assert out.shape == (2, 3, n_grid, 4)
    # ensemble members with different inputs give different outputs
    assert not np.allclose(np.asarray(out[:, 0]), np.asarray(out[:, 1]))


def test_interface_with_imputer_jit(small_graph):
    from helpers_models import make_statistics

    cfg = make_config("gnn")
    cfg.data.processors["imputer"] = {
        "_target_": "anemoi.models.preprocessing.imputer.InputImputer",
        "config": {"default": "none", "mean": ["t2m"]},
    }
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di
    )
    iface.init_params(jax.random.key(0))
    n_grid = small_graph["data"].num_nodes
    batch = np.random.RandomState(0).rand(1, 2, n_grid, 4).astype(np.float32)
    batch[:, :, 7, 3] = np.nan  # t2m NaN at one grid point
    batch = jnp.asarray(batch)
    iface.fit_processors(batch)
    fn = iface.make_predict_fn()
    out = fn(iface.params, batch)
    # the inverse imputer re-inserts NaN at the originally-missing output
    # (reference imputer.py:153-173); everything else must be finite
    t2m = di.model.output.name_to_index["t2m"]
    assert jnp.isnan(out[0, 0, 7, t2m])
    finite_mask = jnp.ones_like(out, bool).at[0, 0, 7, t2m].set(False)
    assert jnp.isfinite(jnp.where(finite_mask, out, 0.0)).all()
    # loss mask exposes the imputed location
    imp = iface.pre_processors.processors["imputer"]
    assert float(imp.loss_mask_training[7, t2m]) == 0.0


def test_inference_chunking_env(small_graph, monkeypatch):
    """ANEMOI_INFERENCE_NUM_CHUNKS controls edge chunking at inference
    (reference block.py:39); chunked result must match unchunked."""
    cfg = make_config("graphtransformer")
    cfg.model.processor.graph_impl = "segment"  # chunking applies to the segment path
    cfg.model.encoder.graph_impl = "segment"
    cfg.model.decoder.graph_impl = "segment"
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=small_graph)
    n_grid = small_graph["data"].num_nodes
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4), jnp.float32)
    params = model.init(jax.random.key(0), x)
    ref = model.apply(params, x)
    monkeypatch.setenv("ANEMOI_INFERENCE_NUM_CHUNKS", "3")
    chunked = model.apply(params, x)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(ref), atol=5e-4, rtol=1e-3)


def test_interface_predict_rollout(small_graph):
    from helpers_models import make_statistics

    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    iface = AnemoiModelInterface(
        config=cfg, graph_data=small_graph, statistics=make_statistics(), data_indices=di
    )
    iface.init_params(jax.random.key(0))
    n_grid = small_graph["data"].num_nodes
    batch = jnp.asarray(np.random.RandomState(3).rand(1, 2, n_grid, 4), jnp.float32)
    n_steps = 3
    forcings = jnp.zeros((n_steps, 1, 1, n_grid, 1), jnp.float32)
    preds = iface.predict_rollout(batch, n_steps, forcings)
    # post-processed output at model-output width per lead time
    assert preds.shape == (n_steps, 1, 1, n_grid, 4)
    assert jnp.isfinite(preds).all()
