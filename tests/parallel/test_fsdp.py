"""ZeRO-1 / FSDP parameter+optimizer sharding (`parallel/fsdp.py`).

The reference replicates weights and Adam moments on every rank (SURVEY
§2.2 TP row: "every rank holds full weights"); these tests pin the
sharded alternative: sharded state trains to the same losses as the
replicated baseline on an emulated mesh, and the state leaves really are
distributed (their shardings name a mesh axis).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from anemoi_models_tpu.graphs import latlon_grid_nodes
from anemoi_models_tpu.parallel import make_mesh
from anemoi_models_tpu.parallel.fsdp import (
    _leaf_spec,
    array_shardings,
    shard_train_state,
    train_state_shardings,
)
from anemoi_models_tpu.training import train_run
from anemoi_models_tpu.training.dataset import SyntheticSource

TINY = dict(
    mesh_refinements=1,
    model_kwargs=dict(num_channels=16, num_layers=2, num_heads=2, num_chunks=1,
                      trainable_hidden=2, trainable_edges=2),
    batch_size=2,
    log_every=100,
)


@pytest.fixture(scope="module")
def source():
    coords = latlon_grid_nodes(8).coords
    return SyntheticSource(coords, num_vars=4, num_steps=48, seed=1)


def test_leaf_spec_rules():
    # largest divisible dim is sharded
    assert _leaf_spec((64, 256), 4, "data", min_size=1024) == PartitionSpec(None, "data")
    # ties broken toward the larger dim; non-divisible dims skipped
    assert _leaf_spec((510, 256), 4, "data", min_size=1024) == PartitionSpec(None, "data")
    # nothing divisible -> replicated
    assert _leaf_spec((510, 255), 4, "data", min_size=1024) == PartitionSpec()
    # small leaves stay replicated
    assert _leaf_spec((8, 8), 4, "data", min_size=1024) == PartitionSpec()


def _sharded_leaf_count(tree) -> int:
    return sum(
        1
        for leaf in jax.tree_util.tree_leaves(tree)
        if hasattr(leaf, "sharding")
        and any(p is not None for p in getattr(leaf.sharding, "spec", PartitionSpec()))
    )


def _run(source, mesh=None, mode=None, **kw):
    return train_run(
        source,
        forcing=("var_0",),
        steps=4,
        peak_lr=2e-3,
        mesh=mesh,
        param_sharding=mode,
        seed=0,
        log=lambda s: None,
        **TINY,
        **kw,
    )


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_training_matches_replicated(source, mode, monkeypatch):
    # the tiny test model's leaves are below the production min-size cutoff;
    # drop it so the sharding actually engages
    import anemoi_models_tpu.parallel.fsdp as fsdp

    monkeypatch.setattr(fsdp, "DEFAULT_MIN_SIZE", 64)

    mesh = make_mesh(data=2, model=2)
    base = _run(source, mesh=mesh, mode=None)
    shard = _run(source, mesh=mesh, mode=mode)
    # base and sharded are DIFFERENT compiled programs (use-site weight
    # all-gathers change fusion/tiling): their fp reassociation noise is
    # independently seeded and adam amplifies it early (tiny second moments
    # -> near-max effective steps), so 4-step losses agree only to a few
    # e-4 relative, not to single-program determinism
    np.testing.assert_allclose(base["losses"], shard["losses"], rtol=6e-4, atol=2e-5)

    state = shard["state"]
    assert _sharded_leaf_count(state.opt_state) > 0, "moments must be sharded"
    n_param_sharded = _sharded_leaf_count(state.params)
    if mode == "zero1":
        assert n_param_sharded == 0, "zero1 keeps params replicated"
    else:
        assert n_param_sharded > 0, "fsdp shards the params"
    # trained params agree across modes (gather the fsdp shards to compare).
    # adam turns any reduction-order noise into ~lr-sized drift (the update
    # magnitude is ~lr wherever grad ≈ 0), so the bound is a couple of
    # lr=2e-3 steps — loose numerically, but a wrong dataflow diverges by
    # orders of magnitude more; the strict check is the loss trajectory above
    for a, b in zip(
        jax.tree_util.tree_leaves(base["state"].params),
        jax.tree_util.tree_leaves(state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-3)


def test_zero1_composes_with_model_axis_and_ema(source, monkeypatch):
    import anemoi_models_tpu.parallel.fsdp as fsdp

    monkeypatch.setattr(fsdp, "DEFAULT_MIN_SIZE", 64)
    mesh = make_mesh(data=2, model=2)
    out = _run(source, mesh=mesh, mode="zero1", ema_decay=0.9)
    assert np.isfinite(out["losses"]).all()
    assert _sharded_leaf_count(out["state"].opt_state) > 0


def test_fsdp_checkpoint_roundtrip(source, tmp_path, monkeypatch):
    """Sharded state saves and resumes exactly (the save gathers to the host; the
    resumed state is re-placed onto the mesh after restore)."""
    import anemoi_models_tpu.parallel.fsdp as fsdp

    monkeypatch.setattr(fsdp, "DEFAULT_MIN_SIZE", 64)
    mesh = make_mesh(data=2, model=2)
    ckpt = str(tmp_path / "run")
    full = _run(source, mesh=mesh, mode="fsdp", checkpoint_dir=ckpt + "_full")

    _run(source, mesh=mesh, mode="fsdp", checkpoint_dir=ckpt, save_every=2,
         max_steps_this_run=2)
    resumed = _run(source, mesh=mesh, mode="fsdp", checkpoint_dir=ckpt, resume=True)
    for a, b in zip(
        jax.tree_util.tree_leaves(full["state"].params),
        jax.tree_util.tree_leaves(resumed["state"].params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_shard_train_state_direct():
    """Unit: placement + sharding trees for a synthetic TrainState."""
    import optax

    from anemoi_models_tpu.training.step import TrainState

    mesh = make_mesh(data=4, model=2)
    params = {"w": jnp.ones((128, 64)), "b": jnp.ones((64,))}
    opt = optax.adam(1e-3)
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))

    for mode, want_param_sharded in (("zero1", False), ("fsdp", True)):
        st, ema, sh, ema_sh = shard_train_state(
            state, mesh, mode=mode, min_size=64, ema=params if mode == "fsdp" else None
        )
        assert (_sharded_leaf_count(st.params) > 0) == want_param_sharded
        assert _sharded_leaf_count(st.opt_state) > 0
        # the sharding trees match what train_state_shardings reports
        ref = train_state_shardings(state, mesh, mode=mode, min_size=64)
        assert jax.tree_util.tree_structure(sh) == jax.tree_util.tree_structure(ref)
    with pytest.raises(ValueError, match="zero1"):
        train_state_shardings(state, mesh, mode="zero3")
