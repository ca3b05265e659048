"""End-to-end tests for the training driver (`training/run.py`).

Covers what the reference delegates to anemoi-training: loss descent over a
real input pipeline, rollout-through-time training, and exact
checkpoint/resume (optimizer moments + EMA + sampler position).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu.graphs import latlon_grid_nodes
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


def test_train_run_descends_and_evaluates(source):
    result = train_run(
        source,
        forcing=("var_0",),
        steps=8,
        peak_lr=5e-3,
        eval_every=8,
        eval_rollout=2,
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 8
    # loss recorded at log boundary + final step
    losses = result["losses"]
    assert losses and np.isfinite(losses).all()
    assert len(result["eval"]) == 1
    ev = result["eval"][0]
    assert np.isfinite(ev["rmse_mean"])
    # training should beat an untrained net quickly on smooth synthetic data
    assert losses[-1] < 1.5


def test_train_run_rollout_training(source):
    result = train_run(
        source,
        forcing=("var_0",),
        rollout=3,
        steps=4,
        peak_lr=3e-3,
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 4
    assert np.isfinite(result["losses"]).all()


def test_train_run_checkpoint_resume(source, tmp_path):
    common = dict(
        forcing=("var_0",),
        peak_lr=2e-3,
        ema_decay=0.99,
        checkpoint_dir=str(tmp_path),
        save_every=2,
        seed=3,
        log=lambda s: None,
        **TINY,
    )
    # one 6-step run vs a 3-update boxed run + resume — must agree exactly
    full = train_run(source, steps=6, **common)

    part = train_run(
        source, steps=6, max_steps_this_run=3,
        **{**common, "checkpoint_dir": str(tmp_path / "b")},
    )
    assert part["steps_done"] == 3
    resumed = train_run(
        source, steps=6, resume=True, **{**common, "checkpoint_dir": str(tmp_path / "b")}
    )
    assert resumed["steps_done"] == 6

    for (ka, a), (kb, b) in zip(
        jax.tree_util.tree_leaves_with_path(full["state"].params),
        jax.tree_util.tree_leaves_with_path(resumed["state"].params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6)
    for a, b in zip(
        jax.tree_util.tree_leaves(full["ema"]), jax.tree_util.tree_leaves(resumed["ema"])
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6)

    # resuming a finished run is a no-op
    again = train_run(
        source, steps=6, resume=True, **{**common, "checkpoint_dir": str(tmp_path / "b")}
    )
    assert again["steps_done"] == 6 and again["losses"] == []

    # the training checkpoint is directly servable (self-contained)
    from anemoi_models_tpu.interface import AnemoiModelInterface

    served = AnemoiModelInterface.from_checkpoint(full["checkpoint"])
    n_grid = len(source.coords)
    n_in = len(served.data_indices.model.input)
    batch = np.random.RandomState(0).rand(1, 2, n_grid, n_in).astype(np.float32)
    out = served.predict_step(jax.numpy.asarray(batch))
    assert out.shape[2] == n_grid and np.isfinite(np.asarray(out)).all()


def test_train_run_hierarchical(source, tmp_path):
    result = train_run(
        source,
        forcing=("var_0",),
        architecture="hierarchical",
        num_hidden_levels=2,
        steps=3,
        peak_lr=2e-3,
        checkpoint_dir=str(tmp_path),
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 3
    assert np.isfinite(result["losses"]).all()
    # hierarchical checkpoints serve + evaluate through the shared surface
    from anemoi_models_tpu.interface import AnemoiModelInterface
    from anemoi_models_tpu.training import evaluate_interface

    served = AnemoiModelInterface.from_checkpoint(result["checkpoint"])
    scores = evaluate_interface(served, source, n_steps=2)
    assert np.isfinite(scores["rmse"]).all()


def test_evaluate_cli(source, tmp_path, capsys):
    from anemoi_models_tpu.commands import main
    from anemoi_models_tpu.training.dataset import save_memmap_dataset

    result = train_run(
        source, forcing=("var_0",), steps=2, peak_lr=1e-3,
        checkpoint_dir=str(tmp_path / "ck"), seed=0, log=lambda s: None, **TINY,
    )
    data = source.window(0, len(source))
    save_memmap_dataset(str(tmp_path / "ds"), data, source.variables, source.coords,
                        statistics=source.statistics)
    rc = main(["evaluate", result["checkpoint"], str(tmp_path / "ds"),
               "--rollout", "2", "--json"])
    assert rc == 0
    import json

    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(scores["rmse"]) == 2
    assert np.isfinite(scores["rmse"]).all()


def test_train_run_under_mesh(source):
    from anemoi_models_tpu.parallel import make_mesh

    mesh = make_mesh(data=2, model=2)
    result = train_run(
        source,
        forcing=("var_0",),
        steps=3,
        peak_lr=2e-3,
        mesh=mesh,
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 3
    assert np.isfinite(result["losses"]).all()


def test_predict_cli(source, tmp_path, capsys):
    """predict writes a physical-space forecast that reopens as a dataset."""
    from anemoi_models_tpu.commands import main
    from anemoi_models_tpu.training import open_dataset
    from anemoi_models_tpu.training.dataset import save_memmap_dataset

    result = train_run(
        source, forcing=("var_0",), steps=2, peak_lr=1e-3,
        checkpoint_dir=str(tmp_path / "ck"), seed=0, log=lambda s: None, **TINY,
    )
    data = source.window(0, len(source))
    save_memmap_dataset(str(tmp_path / "ds"), data, source.variables, source.coords,
                        statistics=source.statistics)

    out_dir = str(tmp_path / "fc")
    rc = main(["predict", result["checkpoint"], str(tmp_path / "ds"),
               "--steps", "2", "--output", out_dir])
    assert rc == 0
    fc = open_dataset(out_dir)
    assert fc.variables == ["var_1", "var_2", "var_3"]
    w = fc.window(0, 2)
    assert w.shape == (2, len(source.coords), 3) and np.isfinite(w).all()
    # physical-space sanity: the residual model's 1-step forecast must stay
    # within a few sigma of the last input state — catches any
    # normalization-scale bug (e.g. double preprocessing) that finiteness
    # checks would miss
    last_input = data[44 + 1][:, [1, 2, 3]]  # start=44, multi_step=2
    std = np.asarray(source.statistics["stdev"])[[1, 2, 3]]
    assert np.all(np.abs(w[0] - last_input) < 5 * std)

    out_npz = str(tmp_path / "fc.npz")
    rc = main(["predict", result["checkpoint"], str(tmp_path / "ds"),
               "--steps", "2", "--output", out_npz])
    assert rc == 0
    z = np.load(out_npz)
    np.testing.assert_allclose(z["forecast"], w, atol=1e-5)


def test_train_run_hybrid_mesh_and_metrics(source, tmp_path):
    """Hybrid (hosts x devices per host) mesh layout trains; metrics.jsonl records steps."""
    import json

    from anemoi_models_tpu.parallel import make_hybrid_mesh

    mesh = make_hybrid_mesh(hosts=2, data_per_host=2, model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    result = train_run(
        source,
        forcing=("var_0",),
        steps=2,
        batch_size=4,
        peak_lr=1e-3,
        mesh=mesh,
        checkpoint_dir=str(tmp_path),
        seed=0,
        log=lambda s: None,
        **{k: v for k, v in TINY.items() if k not in ("batch_size", "log_every")},
        log_every=1,
    )
    assert result["steps_done"] == 2 and np.isfinite(result["losses"]).all()
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)


def test_predict_cli_ensemble(source, tmp_path):
    """Perturbed-IC ensemble: member 0 is the control, spread is nonzero."""
    from anemoi_models_tpu.commands import main
    from anemoi_models_tpu.training.dataset import save_memmap_dataset

    result = train_run(
        source, forcing=("var_0",), steps=2, peak_lr=1e-3,
        checkpoint_dir=str(tmp_path / "ck"), seed=0, log=lambda s: None, **TINY,
    )
    data = source.window(0, len(source))
    save_memmap_dataset(str(tmp_path / "ds"), data, source.variables, source.coords,
                        statistics=source.statistics)

    det = str(tmp_path / "det.npz")
    ens = str(tmp_path / "ens.npz")
    assert main(["predict", result["checkpoint"], str(tmp_path / "ds"),
                 "--steps", "2", "--output", det]) == 0
    assert main(["predict", result["checkpoint"], str(tmp_path / "ds"),
                 "--steps", "2", "--ensemble", "3", "--perturb-sigma", "0.05",
                 "--output", ens]) == 0
    zd, ze = np.load(det), np.load(ens)
    assert ze["members"].shape == (2, 3, len(source.coords), 3)
    # member 0 (unperturbed control) reproduces the deterministic forecast
    np.testing.assert_allclose(ze["members"][:, 0], zd["forecast"], atol=1e-5)
    assert float(ze["ens_std"].mean()) > 0
    assert np.isfinite(ze["members"]).all()


def test_train_run_ensemble_crps(source):
    """CRPS ensemble training runs and reduces the objective."""
    result = train_run(
        source,
        forcing=("var_0",),
        ensemble=3,
        loss="crps",
        perturb_sigma=0.05,
        steps=6,
        peak_lr=5e-3,
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 6
    assert np.isfinite(result["losses"]).all()
    # CRPS of a barely-trained net on smooth data should already be < 1 sigma
    assert result["losses"][-1] < 1.0


def test_train_run_with_diagnostic_variables(source):
    """Diagnostic variables: model predicts them without seeing them as input."""
    result = train_run(
        source,
        forcing=("var_0",),
        diagnostic=("var_3",),
        steps=3,
        peak_lr=2e-3,
        eval_every=3,
        eval_rollout=2,
        seed=0,
        log=lambda s: None,
        **TINY,
    )
    assert result["steps_done"] == 3
    assert np.isfinite(result["losses"]).all()
    idx = result["interface"].data_indices
    assert len(idx.internal_model.input) == 3       # var_3 excluded from inputs
    assert len(idx.internal_model.output) == 3      # var_0 excluded from outputs
    assert np.isfinite(result["eval"][0]["rmse_mean"])


def test_train_run_with_imputer_on_nan_dataset(tmp_path):
    """Real-data warts: NaNs in the dataset flow through imputer fit, the
    loss mask, training, checkpointing, and serving."""
    from anemoi_models_tpu import configs
    from anemoi_models_tpu.interface import AnemoiModelInterface
    from anemoi_models_tpu.training.dataset import SyntheticSource, save_memmap_dataset

    coords = latlon_grid_nodes(8).coords
    src = SyntheticSource(coords, num_vars=4, num_steps=32, seed=5)
    data = src.window(0, 32)
    rng = np.random.RandomState(0)
    # fixed missing locations (ocean-mask style): same grid points at every
    # time step, the static imputer's contract
    hole = rng.rand(data.shape[1]) < 0.1
    data[..., 2] = np.where(hole[None, :], np.nan, data[..., 2])
    ds = save_memmap_dataset(str(tmp_path / "nan_ds"), data, src.variables, coords,
                             statistics=src.statistics)

    config = configs.enc_proc_dec(
        forcing=("var_0",), diagnostic=(), num_channels=16, num_layers=2,
        num_heads=2, num_chunks=1, trainable_hidden=2, trainable_edges=2,
    )
    config.data.processors["imputer"] = {
        "_target_": "anemoi.models.preprocessing.imputer.InputImputer",
        "config": {"default": "none", "mean": ["var_2"]},
    }
    result = train_run(
        ds, config=config, mesh_refinements=1, steps=3, batch_size=2,
        peak_lr=2e-3, checkpoint_dir=str(tmp_path / "ck"),
        seed=0, log=lambda s: None,
    )
    assert np.isfinite(result["losses"]).all()
    # the imputer's training mask reached the loss
    from anemoi_models_tpu.training.run import _loss_mask

    mask = _loss_mask(result["interface"].pre_processors)
    assert mask is not None and float(mask.min()) == 0.0

    # serving from the checkpoint restores the fitted imputer state
    served = AnemoiModelInterface.from_checkpoint(result["checkpoint"])
    raw = ds.window(0, 2)[None]
    src_idx = result["graph"]["data"].attrs.get("source_index")
    hole_rows = hole
    if src_idx is not None:
        raw = raw[:, :, src_idx[:, 0], :]
        hole_rows = hole[src_idx[:, 0]]
    batch = jax.numpy.asarray(raw[..., [0, 1, 2, 3]])
    out = np.asarray(served.predict_step(batch))[0, 0]  # (grid, [var_1,2,3])
    # reference semantics: the imputer's inverse restores NaN exactly at the
    # recorded missing locations of var_2; everything else is finite
    assert np.isnan(out[hole_rows, 1]).all()
    assert np.isfinite(out[~hole_rows, 1]).all()
    assert np.isfinite(out[:, [0, 2]]).all()


def test_train_run_rollout_curriculum_and_var_weights(source):
    """Rollout curriculum switches program mid-run; variable weights apply."""
    logs = []
    result = train_run(
        source,
        forcing=("var_0",),
        rollout_schedule=[(0, 1), (3, 2)],
        variable_loss_weights={"var_1": 2.0, "var_3": 0.5},
        steps=5,
        peak_lr=2e-3,
        seed=0,
        log=logs.append,
        **TINY,
    )
    assert result["steps_done"] == 5
    assert np.isfinite(result["losses"]).all()
    assert any("rollout curriculum: 1 -> 2" in m for m in logs)
    with pytest.raises(ValueError, match="non-output"):
        train_run(source, forcing=("var_0",), steps=1,
                  variable_loss_weights={"var_0": 2.0},  # forcing, not output
                  seed=0, log=lambda s: None, **TINY)


def test_train_run_warm_start(source, tmp_path):
    """init_from fine-tuning: params load, optimizer/schedule start fresh."""
    pre = train_run(
        source, forcing=("var_0",), steps=3, peak_lr=2e-3,
        checkpoint_dir=str(tmp_path / "pre"), seed=0, log=lambda s: None, **TINY,
    )
    logs = []
    ft = train_run(
        source, forcing=("var_0",), steps=2, peak_lr=1e-4, loss="crps",
        ensemble=2, init_from=pre["checkpoint"],
        checkpoint_dir=str(tmp_path / "ft"), seed=1, log=logs.append, **TINY,
    )
    assert any("warm-started" in m for m in logs)
    assert ft["steps_done"] == 2 and np.isfinite(ft["losses"]).all()
    # fine-tuned params moved away from the warm start
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(pre["state"].params),
                        jax.tree_util.tree_leaves(ft["state"].params))
    )
    assert moved


def test_train_run_sigterm_checkpoint(tmp_path):
    """SIGTERM mid-run checkpoints gracefully; resume continues the run."""
    import os
    import signal
    import subprocess
    import sys
    import textwrap
    import time as _time

    script = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from anemoi_models_tpu.graphs import latlon_grid_nodes
        from anemoi_models_tpu.training import train_run
        from anemoi_models_tpu.training.dataset import SyntheticSource

        coords = latlon_grid_nodes(8).coords
        source = SyntheticSource(coords, num_vars=4, num_steps=48, seed=1)
        result = train_run(
            source, forcing=("var_0",), steps=500, batch_size=2,
            mesh_refinements=1,
            model_kwargs=dict(num_channels=16, num_layers=2, num_heads=2,
                              num_chunks=1, trainable_hidden=2, trainable_edges=2),
            peak_lr=1e-3, checkpoint_dir=%r, seed=0, log_every=1,
        )
        print("INTERRUPTED" if result.get("interrupted") else "FINISHED", flush=True)
    """) % (os.getcwd(), str(tmp_path))
    env = {**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # wait for training to produce at least one metrics record, then SIGTERM
    metrics = tmp_path / "metrics.jsonl"
    deadline = _time.time() + 240
    while _time.time() < deadline and not metrics.exists():
        _time.sleep(1.0)
        assert proc.poll() is None, proc.stdout.read()
    assert metrics.exists(), "training never reached a logged step"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert "INTERRUPTED" in out, out
    assert "checkpoint saved" in out

    # resume picks up from the interrupted step
    from anemoi_models_tpu.checkpoint import load_checkpoint

    restored = load_checkpoint(str(tmp_path / "latest"))
    assert 0 < int(restored["step"]) < 500


def test_resolve_remat_policy_limits():
    """The auto resolver keys off the compiled peak vs the injected budget."""
    import optax

    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.models import AnemoiModelEncProcDec
    from anemoi_models_tpu.training.step import resolve_remat_policy
    from tests.helpers_models import VARS, make_config, small_graph_cached

    cfg = make_config("graphtransformer")
    graph = small_graph_cached()
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    n_in = len(di.internal_model.input)
    n_out = len(di.internal_model.output)
    x_shape = (1, 2, 1, n_grid, n_in)
    y_shape = (1, 1, n_grid, n_out)
    msgs = []
    huge = resolve_remat_policy(
        model, optax.adam(1e-3), x_shape, y_shape,
        limit_bytes=1 << 40, log=msgs.append,
    )
    tiny = resolve_remat_policy(
        model, optax.adam(1e-3), x_shape, y_shape,
        limit_bytes=1 << 10, log=msgs.append,
    )
    unknown = resolve_remat_policy(
        model, optax.adam(1e-3), x_shape, y_shape,
        limit_bytes=0, log=msgs.append,
    )
    assert huge == "none" and tiny == "full" and unknown == "full"
    assert any("remat auto" in m for m in msgs)


def test_train_run_auto_remat(tmp_path):
    """remat_policy='auto' resolves before training and the run completes."""
    from anemoi_models_tpu.graphs import latlon_grid_nodes
    from anemoi_models_tpu.training.dataset import SyntheticSource

    coords = latlon_grid_nodes(8).coords
    source = SyntheticSource(coords, num_vars=4, num_steps=12, seed=0)
    msgs = []
    out = train_run(
        source, forcing=("var_0",), mesh_refinements=1,
        model_kwargs=dict(num_channels=16, num_layers=2, num_heads=4,
                          num_chunks=1, remat_policy="auto"),
        steps=2, batch_size=1, seed=0, log=msgs.append,
    )
    assert np.isfinite(out["losses"]).all()


def test_resolve_remat_policy_real_variant():
    """The auto proxy compiles the step variant the run executes: rollout
    scan + ensemble axis + CRPS + EMA thread (advisor round-4 finding — a
    plain single-step adam proxy understates those peaks)."""
    import optax

    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.models import AnemoiModelEncProcDec
    from anemoi_models_tpu.training.loss import WeightedCRPSLoss
    from anemoi_models_tpu.training.step import resolve_remat_policy
    from tests.helpers_models import VARS, make_config, small_graph_cached

    cfg = make_config("graphtransformer")
    graph = small_graph_cached()
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    n_in = len(di.internal_model.input)
    n_out = len(di.internal_model.output)
    x_shape = (1, 2, 1, n_grid, n_in)
    y_shape = (1, 1, n_grid, n_out)
    area = jnp.ones((n_grid,), jnp.float32)
    msgs = []
    got = resolve_remat_policy(
        model, optax.adam(1e-3), x_shape, y_shape,
        indices=di, rollout=2, ensemble=3,
        loss_fn=WeightedCRPSLoss(node_weights=area),
        ema=True, limit_bytes=1 << 40, log=msgs.append,
    )
    assert got == "none"  # tiny model under a 1 TiB budget
    assert any("remat auto" in m for m in msgs)
    # the same variant under an impossible budget falls back to full
    got = resolve_remat_policy(
        model, optax.adam(1e-3), x_shape, y_shape,
        indices=di, rollout=2, ensemble=3,
        loss_fn=WeightedCRPSLoss(node_weights=area),
        ema=True, limit_bytes=1 << 10, log=msgs.append,
    )
    assert got == "full"


def test_train_run_auto_remat_rollout_ensemble(tmp_path):
    """auto remat resolves through the rollout+ensemble+EMA proxy and the
    run completes."""
    from anemoi_models_tpu.graphs import latlon_grid_nodes
    from anemoi_models_tpu.training.dataset import SyntheticSource

    coords = latlon_grid_nodes(8).coords
    source = SyntheticSource(coords, num_vars=4, num_steps=16, seed=0)
    msgs = []
    out = train_run(
        source, forcing=("var_0",), mesh_refinements=1,
        model_kwargs=dict(num_channels=16, num_layers=2, num_heads=4,
                          num_chunks=1, remat_policy="auto"),
        steps=2, batch_size=1, seed=0, rollout=2, ensemble=2, loss="crps",
        ema_decay=0.99, log=msgs.append,
    )
    assert np.isfinite(out["losses"]).all()


def test_train_run_overlap_matches_serial(source):
    """overlap_calls defers loss fetches to overlap loader staging with
    device execution; the
    dispatched programs and their order are identical, so losses must match
    the serial mode exactly — including across an eval boundary, where the
    overlap path must flush pending fetches before using the state."""

    def run(overlap):
        return train_run(
            source,
            forcing=("var_0",),
            steps=8,
            steps_per_call=2,
            overlap_calls=overlap,
            eval_every=4,
            eval_rollout=2,
            peak_lr=5e-3,
            seed=0,
            log=lambda s: None,
            **TINY,
        )

    serial = run(False)
    overlapped = run(True)
    np.testing.assert_array_equal(serial["losses"], overlapped["losses"])
    assert len(serial["eval"]) == len(overlapped["eval"]) == 2
    for a, b in zip(serial["eval"], overlapped["eval"]):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["rmse_mean"], b["rmse_mean"], rtol=0, atol=0)
    assert serial["steps_done"] == overlapped["steps_done"] == 8
