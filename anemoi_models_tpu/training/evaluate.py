"""Rollout evaluation: per-variable, per-lead-time skill scores.

Infrastructure for a 72h-rollout-RMSE benchmark protocol: run the
autoregressive rollout against held-out truth and report
area-weighted RMSE (and anomaly correlation) per variable and lead time,
plus the persistence baseline every forecast must beat.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.training.rollout import make_rollout_fn

__all__ = ["rollout_scores", "evaluate_rollout", "evaluate_interface"]


def _wmean(x: jnp.ndarray, w: Optional[jnp.ndarray], axes) -> jnp.ndarray:
    if w is None:
        return x.mean(axes)
    w = jnp.broadcast_to(w[..., None], x.shape)
    return (x * w).sum(axes) / w.sum(axes)


def rollout_scores(
    preds: jnp.ndarray,
    truth: jnp.ndarray,
    node_weights: Optional[jnp.ndarray] = None,
    climatology: Optional[jnp.ndarray] = None,
) -> dict[str, np.ndarray]:
    """Scores for rollout predictions vs truth.

    preds/truth: (steps, batch, ensemble, grid, vars); node_weights: (grid,);
    climatology: (grid, vars) for anomaly correlation. Returns per
    (step, var) arrays: rmse, mae, and acc when climatology given.
    """
    err = (preds.astype(jnp.float32) - truth.astype(jnp.float32))
    space_axes = (1, 2, 3)
    out = {
        "rmse": np.asarray(jnp.sqrt(_wmean(err**2, node_weights, space_axes))),
        "mae": np.asarray(_wmean(jnp.abs(err), node_weights, space_axes)),
    }
    if climatology is not None:
        pa = preds.astype(jnp.float32) - climatology
        ta = truth.astype(jnp.float32) - climatology
        num = _wmean(pa * ta, node_weights, space_axes)
        den = jnp.sqrt(
            _wmean(pa**2, node_weights, space_axes) * _wmean(ta**2, node_weights, space_axes)
        )
        out["acc"] = np.asarray(num / jnp.maximum(den, 1e-12))
    return out


def evaluate_interface(
    iface: Any,
    source: Any,
    n_steps: int = 4,
    start: Optional[int] = None,
    params: Any = None,
    acc: bool = False,
    ensemble: int = 1,
    perturb_sigma: float = 0.05,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Score a checkpointed/built interface on a window of a `DataSource`.

    Rolls ``n_steps`` from ``start`` (default: the dataset tail) and returns
    :func:`evaluate_rollout`'s model-vs-persistence scores, handling the
    dataset→graph grid permutation and preprocessing internally — the
    one-call eval for ``AnemoiModelInterface.from_checkpoint`` artifacts.
    ``acc=True`` adds anomaly correlation against a climatology estimated
    from the dataset (time mean over up to 64 evenly spaced steps).
    ``ensemble`` > 1 rolls M members from perturbed initial conditions
    (normalized-space noise on prognostic inputs) and adds per-lead-time
    fair CRPS, ensemble spread, and the spread/skill ratio — the standard
    ensemble-calibration diagnostics (ratio ≈ 1 for a reliable ensemble).
    """
    indices = iface.data_indices
    graph = iface.graph_data
    data_node = iface.config.graph.get("data", "data")
    multi_step = iface.multi_step
    if start is None:
        start = len(source) - (multi_step + n_steps)
    src_idx = graph[data_node].attrs.get("source_index")
    perm = None if src_idx is None else np.ascontiguousarray(src_idx[:, 0])

    def pre_windows(raw: np.ndarray) -> jnp.ndarray:
        if perm is not None:
            raw = raw[:, :, perm, :]
        return iface.pre_processors(jnp.asarray(raw), in_place=False)

    pre = pre_windows(source.window(start, multi_step + n_steps)[None])
    data_in = np.asarray(indices.internal_data.input.full)
    x0 = pre[:, :multi_step, None][..., data_in]
    truth_in = jnp.moveaxis(pre[:, multi_step:, None][..., data_in], 1, 0)
    area = jnp.asarray(graph[data_node].attrs["area_weight"][:, 0])

    climatology = None
    if acc:
        # time-mean state in normalized space, at prognostic-input width:
        # one stacked batch of up to 64 evenly spaced single-step windows,
        # preprocessed in one pass
        sample = np.unique(np.linspace(0, len(source) - 1, 64).astype(int))
        stacked = np.stack([source.window(int(t), 1) for t in sample])
        mean = np.asarray(pre_windows(stacked)).mean(axis=(0, 1))
        prog_in = np.asarray(indices.internal_model.input.prognostic)
        climatology = jnp.asarray(mean[:, data_in][:, prog_in])

    params = params if params is not None else iface.params
    scores = evaluate_rollout(
        iface.model, indices, params, x0, truth_in,
        node_weights=area, climatology=climatology,
    )
    if ensemble > 1:
        from anemoi_models_tpu.training.loss import crps_ensemble

        prog_in = np.asarray(indices.internal_model.input.prognostic)
        prog_out = np.asarray(indices.internal_model.output.prognostic)
        forcing_in = np.asarray(indices.internal_model.input.forcing)
        x0_m = jnp.repeat(x0, ensemble, axis=2)
        noise = perturb_sigma * jax.random.normal(jax.random.key(seed), x0_m.shape, x0_m.dtype)
        if forcing_in.size:
            noise = noise.at[..., forcing_in].set(0.0)
        rollout = jax.jit(make_rollout_fn(iface.model, indices, n_steps))
        forcings = truth_in[..., forcing_in] if forcing_in.size else None
        _, preds = rollout(params, x0_m + noise, forcings)
        members = preds[..., prog_out]  # (steps, b, M, grid, vp)
        truth = truth_in[..., prog_in]
        crps = np.asarray([
            float(crps_ensemble(members[t], truth[t], node_weights=area))
            for t in range(n_steps)
        ])
        # fair (ddof=1) member variance, area-weighted over the grid so the
        # ratio against the area-weighted RMSE is meaningful
        w = area / area.sum()
        var = members.var(axis=2, ddof=1)  # (steps, b, grid, vp)
        spread = np.asarray(jnp.sqrt((var * w[:, None]).sum(axis=2).mean(axis=(1, 2))))
        mean_rmse = rollout_scores(
            members.mean(axis=2, keepdims=True), truth, node_weights=area
        )["rmse"].mean(axis=1)
        scores["crps"] = crps
        scores["spread"] = spread
        scores["spread_skill_ratio"] = spread / np.maximum(mean_rmse, 1e-12)
        scores["ens_mean_rmse"] = mean_rmse
    return scores


def evaluate_rollout(
    model: Any,
    data_indices: Any,
    params: Any,
    x0: jnp.ndarray,
    truth_inputs: jnp.ndarray,
    node_weights: Optional[jnp.ndarray] = None,
    climatology: Optional[jnp.ndarray] = None,
) -> dict[str, np.ndarray]:
    """Roll the model forward against truth and score it vs persistence.

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window.
    - ``truth_inputs``: (steps, batch, ensemble, grid, n_in) future states at
      the internal-model *input* width (forcings are read from it).
    - ``climatology``: optional (grid, n_prognostic) reference state for
      anomaly correlation (same normalized space as the inputs).
    Returns rmse/mae (and acc when climatology is given) per
    (step, prognostic var) for the model and for the persistence forecast.
    """
    n_steps = truth_inputs.shape[0]
    prog_in = np.asarray(data_indices.internal_model.input.prognostic)
    prog_out = np.asarray(data_indices.internal_model.output.prognostic)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)

    forcings = truth_inputs[..., forcing_in] if forcing_in.size else None
    rollout = jax.jit(make_rollout_fn(model, data_indices, n_steps))
    _, preds = rollout(params, x0, forcings)

    truth_prog = truth_inputs[..., prog_in]
    model_scores = rollout_scores(preds[..., prog_out], truth_prog, node_weights, climatology)
    persistence = jnp.broadcast_to(x0[:, -1][None][..., prog_in], truth_prog.shape)
    persist_scores = rollout_scores(persistence, truth_prog, node_weights, climatology)
    out = {
        "rmse": model_scores["rmse"],
        "mae": model_scores["mae"],
        "persistence_rmse": persist_scores["rmse"],
        "skill_vs_persistence": 1.0 - model_scores["rmse"] / np.maximum(persist_scores["rmse"], 1e-12),
    }
    if climatology is not None:
        out["acc"] = model_scores["acc"]
        out["persistence_acc"] = persist_scores["acc"]
    return out
