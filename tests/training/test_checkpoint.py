import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.checkpoint import load_checkpoint, save_checkpoint
from anemoi_models_tpu.layers import MLP


def test_checkpoint_roundtrip(tmp_path):
    mlp = MLP(hidden_dim=8, out_features=4)
    x = jnp.ones((2, 6))
    params = mlp.init(jax.random.key(0), x)
    proc_state = {"imputer": {"nan_locations": jnp.zeros((5, 3), bool)}}

    path = save_checkpoint(
        str(tmp_path / "ckpt"),
        params=params,
        processor_state=proc_state,
        step=7,
        metadata={"experiment": "unit"},
        config={"model": {"num_channels": 8}},
        supporting_arrays={"latitudes": np.arange(5.0)},
        run_id="abc-123",
    )
    restored = load_checkpoint(path)
    assert restored["step"] == 7
    assert restored["run_id"] == "abc-123"
    assert restored["metadata"]["experiment"] == "unit"
    np.testing.assert_array_equal(restored["supporting_arrays"]["latitudes"], np.arange(5.0))
    for (kp, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(restored["params"]),
        jax.tree_util.tree_leaves_with_path(params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(restored["processor_state"]["imputer"]["nan_locations"]),
        np.zeros((5, 3), bool),
    )


def test_checkpoint_bit_exact_dtypes(tmp_path):
    """Every leaf comes back with its dtype and bits, bfloat16 included, and
    a target restore keeps the target's tree structure (namedtuples too)."""
    import optax

    tree = {
        "w": jnp.asarray(np.random.RandomState(0).randn(3, 4), jnp.bfloat16),
        "b": jnp.arange(5, dtype=jnp.int32),
        "m": jnp.asarray([True, False]),
        "f": jnp.asarray(np.random.RandomState(1).randn(7), jnp.float32),
    }
    opt_state = optax.adam(1e-3).init(tree["f"])
    path = save_checkpoint(str(tmp_path / "c"), params=tree, opt_state=opt_state, step=1)
    raw = load_checkpoint(path)
    for k, v in tree.items():
        assert raw["params"][k].dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(raw["params"][k]), np.asarray(v))
    got = load_checkpoint(path, target={"params": tree, "opt_state": opt_state})
    assert jax.tree_util.tree_structure(got["opt_state"]) == jax.tree_util.tree_structure(opt_state)
    for a, b in zip(jax.tree_util.tree_leaves((got["params"], got["opt_state"])),
                    jax.tree_util.tree_leaves((tree, opt_state))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_hello(capsys):
    from anemoi_models_tpu.commands import main

    assert main(["hello", "--name", "anemoi"]) == 0
    assert "Hello, anemoi!" in capsys.readouterr().out


def test_cli_info(capsys):
    from anemoi_models_tpu.commands import main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "anemoi-models-tpu" in out and "backend" in out


def test_checkpoint_migrates_emb_nodes_src_scope(tmp_path):
    """Format-1 checkpoints (wide layout: mapper-scope emb_nodes_src) restore
    into format-2 targets (narrow layout: block-scope emb_nodes_src) and
    back — including adam moments, which mirror the parameter structure."""
    import optax

    from anemoi_models_tpu.layers.mapper import GraphTransformerForwardMapper
    from helpers_models import small_graph_cached

    graph = small_graph_cached()
    es = graph[("data", "to", "hidden")]
    ng, nm = graph["data"].num_nodes, graph["hidden"].num_nodes
    x = (
        jnp.asarray(np.random.RandomState(0).randn(1, ng, 10), jnp.float32),
        jnp.asarray(np.random.RandomState(1).randn(1, nm, 12), jnp.float32),
    )
    kw = dict(in_channels_src=10, in_channels_dst=12, hidden_dim=16, num_heads=4, sub_graph=es)
    wide = GraphTransformerForwardMapper(kv_src_gather="wide", **kw)
    narrow = GraphTransformerForwardMapper(kv_src_gather="narrow", **kw)

    opt = optax.adam(1e-3)
    p_wide = wide.init(jax.random.key(0), x)
    path = save_checkpoint(
        str(tmp_path / "legacy"), params=p_wide, opt_state=opt.init(p_wide), step=3
    )

    p_narrow = narrow.init(jax.random.key(1), x)
    target = {"params": p_narrow, "opt_state": opt.init(p_narrow)}
    restored = load_checkpoint(path, target=target)

    # every wide leaf must land somewhere in the narrow tree, values intact
    wide_leaves = sorted(
        (jax.tree_util.keystr(k), np.asarray(v).sum())
        for k, v in jax.tree_util.tree_leaves_with_path(p_wide)
    )
    got_leaves = sorted(
        (jax.tree_util.keystr(k), np.asarray(v).sum())
        for k, v in jax.tree_util.tree_leaves_with_path(restored["params"])
    )
    assert [round(float(s), 5) for _, s in got_leaves] == [
        round(float(s), 5) for _, s in wide_leaves
    ]
    # structure now matches the narrow model: apply must run and agree with
    # the wide model on the same weights
    out_w = wide.apply(p_wide, x)[1]
    out_n = narrow.apply(restored["params"], x)[1]
    np.testing.assert_allclose(np.asarray(out_n), np.asarray(out_w), rtol=2e-5, atol=2e-5)
    # adam moments migrated with the same move
    assert jax.tree_util.tree_structure(restored["opt_state"]) == jax.tree_util.tree_structure(
        target["opt_state"]
    )
