"""End-to-end training driver: dataset → graph → model → optimized loop.

The reference splits this across anemoi-training (Lightning loop, rollout
schedule, checkpoint cadence) and anemoi-datasets (zarr readers); here one
function owns the whole run, built from this package's parts:

- graph built from the dataset's own coordinates (``nodes_from_coords``),
  so any grid the data comes on works — no resampling step;
- background `BatchLoader` + `device_prefetch` keep the device fed;
- single-step (`make_train_step`) or autoregressive rollout training
  (`make_rollout_train_step`) in one jitted program, preprocessing
  included — host work per step is one queue pop;
- optional `jax.sharding.Mesh`: the batch is laid out over the ``data``
  axis at transfer time and every model-internal sharding constraint
  (grid over ``model``) applies as in serving;
- AdamW + warmup/cosine, parameter EMA, checkpointing with full
  resume (optimizer state, EMA, sampler position), periodic rollout
  evaluation scored against persistence.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.training.dataset import DataSource
from anemoi_models_tpu.training.evaluate import evaluate_interface
from anemoi_models_tpu.training.loader import BatchLoader, WindowSampler, device_prefetch
from anemoi_models_tpu.training.loss import WeightedCRPSLoss, WeightedMSELoss
from anemoi_models_tpu.training.optim import ema_update, make_optimizer
from anemoi_models_tpu.training.step import make_rollout_train_step, make_train_step

__all__ = ["train_run"]


def _wants_dropout(model_config) -> bool:
    """True if any sub-config under config.model declares dropout_p > 0."""

    def walk(node) -> bool:
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "dropout_p" and float(value or 0.0) > 0.0:
                    return True
                if walk(value):
                    return True
        return False

    return walk(model_config)


def _loss_mask(pipeline) -> Optional[jnp.ndarray]:
    """The imputer's (grid, vars_out) training mask, if any processor fit one."""
    for proc in getattr(pipeline, "processors", {}).values():
        mask = getattr(proc, "loss_mask_training", None)
        if mask is not None:
            return mask
    return None


def train_run(
    source: DataSource,
    *,
    config=None,
    forcing: tuple = (),
    diagnostic: tuple = (),
    flavor: str = "graphtransformer",
    architecture: str = "enc_proc_dec",
    num_hidden_levels: int = 2,
    mesh_refinements: int = 3,
    model_kwargs: Optional[dict] = None,
    steps: int = 100,
    max_steps_this_run: Optional[int] = None,
    batch_size: int = 2,
    rollout: int = 1,
    rollout_schedule=None,
    variable_loss_weights: Optional[dict] = None,
    ensemble: int = 1,
    perturb_sigma: float = 0.05,
    loss: str = "mse",
    peak_lr: float = 1e-3,
    warmup_steps: Optional[int] = None,
    weight_decay: float = 0.0,
    ema_decay: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    resume: bool = False,
    init_from: Optional[str] = None,
    eval_every: int = 0,
    eval_rollout: int = 4,
    mesh=None,
    param_sharding: Optional[str] = None,
    param_sharding_axis: str = "data",
    seed: int = 0,
    log_every: int = 10,
    log: Callable[[str], None] = print,
    loader_depth: int = 4,
    loader_workers: int = 1,
    prefetch: int = 2,
    steps_per_call: int = 1,
    overlap_calls: bool = True,
    handle_signals: bool = True,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (10, 13),
) -> dict:
    """Train a forecast model on ``source``; returns a run summary dict.

    ``rollout`` > 1 trains through that many autoregressive steps per update
    (each batch window is ``multistep_input + rollout`` long). ``config``
    defaults to the :func:`anemoi_models_tpu.configs.enc_proc_dec` preset for
    ``flavor`` with ``model_kwargs`` applied. With ``checkpoint_dir`` +
    ``resume=True`` the run continues exactly where it stopped: parameters,
    optimizer moments, EMA, and the sampler's epoch/position all restore.

    ``rollout_schedule`` implements the rollout curriculum (anemoi-training
    style): ``[(0, 1), (5000, 2), (8000, 4)]`` trains 1-step until update
    5000, then 2-step, then 4-step — each length is its own compiled
    program, windows are sized for the longest. ``variable_loss_weights``
    maps output variable names to loss weights (pressure-level scaling).

    ``ensemble`` > 1 trains an M-member ensemble: each batch's initial
    window is replicated over the model's native ensemble axis with
    normalized-space perturbations on prognostic inputs (``perturb_sigma``
    stdevs, forcings pinned), and the natural objective is ``loss="crps"``
    (fair ensemble CRPS, the AIFS-CRPS recipe) — ``loss`` also accepts
    "mse" for deterministic training and works with either ensemble size.

    ``init_from`` warm-starts from another run's checkpoint: parameters
    and fitted processor state load, but the optimizer, schedule, and
    sampler start fresh — the fine-tuning entry (e.g. pretrain with
    ``loss="mse"``, then CRPS fine-tune into a new ``checkpoint_dir``).

    ``param_sharding`` (requires ``mesh``) shards optimizer memory instead
    of replicating it per chip (``parallel/fsdp.py``): ``"zero1"`` shards
    the Adam moments over ``param_sharding_axis`` (params stay replicated),
    ``"fsdp"`` shards params, moments, and EMA (weights are all-gathered at
    their use sites by GSPMD). The reference replicates everything
    (SURVEY §2.2 TP row); at AIFS widths the replicated fp32 moments are
    pure per-chip overhead this removes.

    With ``handle_signals`` (default, main thread only) SIGTERM/SIGINT
    request a graceful stop: the loop finishes the in-flight update,
    checkpoints, and returns — on preemptible machines the eviction notice
    becomes a clean resume point. ``profile_dir`` captures an xplane trace
    of steps ``profile_steps=[start, stop)``.

    ``steps_per_call`` > 1 batches that many optimizer steps into one
    compiled program (their input batches staged together), amortizing the
    per-dispatch host/runtime overhead on dispatch-expensive runtimes.
    Numerics are identical to step-at-a-time; per-step losses still log.
    Eval/save/profile points force a call boundary, so their cadence is
    exact; interrupts land on the next boundary (≤ ``steps_per_call`` steps
    away).

    ``steps`` is the full training horizon (it sets the LR schedule);
    ``max_steps_this_run`` optionally boxes how many updates this invocation
    performs, for time-limited sessions — checkpoint, then resume later and
    the trajectory is identical to an uninterrupted run.

    Returns ``{"state", "interface", "losses", "eval", "steps_done", ...}``.
    """
    from anemoi_models_tpu import configs
    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.graphs import (
        build_enc_proc_dec_graph,
        build_hierarchical_graph,
        nodes_from_coords,
    )
    from anemoi_models_tpu.interface import AnemoiModelInterface
    from anemoi_models_tpu.parallel import use_mesh

    model_kwargs = dict(model_kwargs or {})
    # remat_policy="auto": build with "none" first; after shapes are known
    # the compiled memory analysis decides whether to keep it ("none"
    # skips the backward recompute when the activations fit)
    auto_remat = model_kwargs.get("remat_policy") == "auto" and config is None
    if model_kwargs.get("remat_policy") == "auto":
        model_kwargs["remat_policy"] = "none" if auto_remat else "full"
    data_nodes = nodes_from_coords(np.asarray(source.coords, np.float64))
    if architecture == "hierarchical":
        graph, hidden_names = build_hierarchical_graph(
            data_nodes=data_nodes,
            mesh_refinements=mesh_refinements,
            num_levels=num_hidden_levels,
        )

        def make_config(mk):
            return configs.hierarchical(
                forcing=tuple(forcing),
                diagnostic=tuple(diagnostic),
                hidden_names=hidden_names,
                flavor=flavor,
                **mk,
            )

    else:
        assert architecture == "enc_proc_dec", f"unknown architecture {architecture!r}"
        graph = build_enc_proc_dec_graph(
            data_nodes=data_nodes, mesh_refinements=mesh_refinements
        )

        def make_config(mk):
            return configs.enc_proc_dec(
                forcing=tuple(forcing), diagnostic=tuple(diagnostic), flavor=flavor,
                **mk,
            )

    if config is None:
        config = make_config(model_kwargs)

    def make_iface(cfg):
        idx = IndexCollection(cfg, source.name_to_index)
        return idx, AnemoiModelInterface(
            config=cfg,
            graph_data=graph,
            statistics=source.statistics,
            data_indices=idx,
            metadata={"dataset": getattr(source, "path", type(source).__name__)},
        )

    indices, iface = make_iface(config)
    if auto_remat:
        from anemoi_models_tpu.training.step import resolve_remat_policy

        ms = int(config.training.multistep_input)
        n_grid = graph["data"].num_nodes
        # the proxy compiles the step variant this run will execute: max
        # curriculum rollout, the ensemble axis, the run's loss (CRPS
        # materializes member-pair terms), the real optimizer chain, and the
        # EMA thread (advisor round-4 finding: a plain single-step adam
        # proxy understates all of these)
        max_ro = max(
            (int(r) for _, r in rollout_schedule), default=rollout
        ) if rollout_schedule else rollout
        area_proxy = jnp.asarray(graph["data"].attrs["area_weight"][:, 0])
        loss_proxy = (
            WeightedCRPSLoss(node_weights=area_proxy)
            if loss == "crps"
            else WeightedMSELoss(node_weights=area_proxy)
        )
        opt_proxy = make_optimizer(
            peak_lr,
            warmup_steps=min(
                warmup_steps if warmup_steps is not None else max(steps // 10, 1), steps
            ),
            total_steps=steps,
            weight_decay=weight_decay,
        )
        chosen = resolve_remat_policy(
            iface.model,
            opt_proxy,
            (batch_size, ms, 1, n_grid, len(indices.internal_model.input)),
            (batch_size, 1, n_grid, len(indices.internal_model.output)),
            indices=indices,
            rollout=max_ro,
            ensemble=ensemble,
            loss_fn=loss_proxy,
            ema=ema_decay is not None,
            log=log,
        )
        if chosen != "none":
            model_kwargs["remat_policy"] = chosen
            config = make_config(model_kwargs)
            indices, iface = make_iface(config)

    multi_step = int(config.training.multistep_input)
    if rollout_schedule:
        sched = sorted((int(u), int(r)) for u, r in rollout_schedule)
        if sched[0][0] != 0:
            raise ValueError("rollout_schedule must define a length from step 0")
    else:
        sched = [(0, rollout)]
    max_rollout = max(r for _, r in sched)

    def rollout_at(step_no: int) -> int:
        return max(r for u, r in sched if u <= step_no)

    window = multi_step + max_rollout
    # dataset rows → graph order (mesh-locality permutation from the builder)
    src_idx = graph["data"].attrs.get("source_index")
    grid_perm = None if src_idx is None else np.ascontiguousarray(src_idx[:, 0])

    # column routing at the internal (post-remap) level
    data_in = np.asarray(indices.internal_data.input.full)
    data_out = np.asarray(indices.internal_data.output.full)

    # keep an eval tail the sampler never sees
    eval_window = (multi_step + eval_rollout) if eval_every else 0
    train_steps_avail = len(source) - eval_window
    sampler = WindowSampler(train_steps_avail, window, batch_size, seed=seed)

    def ingest(raw: np.ndarray) -> np.ndarray:
        return raw[:, :, grid_perm, :] if grid_perm is not None else raw

    # fit stateful processors (imputer masks) on the first window
    first = ingest(source.window(0, window)[None])
    iface.fit_processors(jnp.asarray(first))

    warm = None
    if init_from:
        from anemoi_models_tpu.checkpoint import load_checkpoint

        # untargeted restore: the donor's optimizer subtree is irrelevant
        # (this run's optimizer starts fresh); restore the donor's fitted
        # processor state NOW, before the loss captures the imputer mask
        warm = load_checkpoint(init_from)
        if "processor_state" in warm:
            iface.pre_processors.load_state_dict(warm["processor_state"])
            iface.post_processors.load_state_dict(warm["processor_state"])

    area = jnp.asarray(graph["data"].attrs["area_weight"][:, 0])
    var_w = None
    if variable_loss_weights:
        out_n2i = indices.internal_model.output.name_to_index
        unknown = sorted(set(variable_loss_weights) - set(out_n2i))
        if unknown:
            raise ValueError(f"variable_loss_weights for non-output variables: {unknown}")
        var_w = np.ones(len(out_n2i), np.float32)
        for name, wgt in variable_loss_weights.items():
            var_w[out_n2i[name]] = wgt
        var_w = jnp.asarray(var_w)
    if loss == "crps":
        loss_fn = WeightedCRPSLoss(node_weights=area, variable_weights=var_w,
                                   loss_mask=_loss_mask(iface.pre_processors))
    else:
        assert loss == "mse", f"loss must be 'mse' or 'crps', got {loss!r}"
        loss_fn = WeightedMSELoss(node_weights=area, variable_weights=var_w,
                                  loss_mask=_loss_mask(iface.pre_processors))
    optimizer = make_optimizer(
        peak_lr,
        warmup_steps=min(warmup_steps if warmup_steps is not None else max(steps // 10, 1), steps),
        total_steps=steps,
        weight_decay=weight_decay,
    )

    # Training uses the dropout-enabled twin of the serving model whenever
    # the config asks for dropout_p > 0 (same parameter tree — dropout draws
    # no params — so checkpoints/EMA/serving all stay interchangeable; the
    # reference trains with attention-weight dropout, ``attention.py:60``).
    train_model = (
        iface.model.clone(deterministic=False) if _wants_dropout(config.model) else iface.model
    )

    # one compiled step program per distinct rollout length (the curriculum
    # switches between them; parameters/optimizer state are shared)
    init_state, _core_1 = make_train_step(train_model, optimizer, loss_fn, dropout_seed=seed + 3)
    _cores: dict = {1: _core_1}

    def step_core_for(r: int):
        if r not in _cores:
            _cores[r] = make_rollout_train_step(
                train_model, indices, optimizer, r, loss_fn, dropout_seed=seed + 3
            )[1]
        return _cores[r]

    forcing_in = np.asarray(indices.internal_model.input.forcing)
    base_key = jax.random.key(seed + 1)

    def prep(raw: jnp.ndarray, step=None):
        pre = iface.pre_processors(raw, in_place=False)  # (b, window, grid, vars)
        x0 = pre[:, :multi_step, None][..., data_in]
        if ensemble > 1:
            # M members on the model's native ensemble axis, normalized-space
            # IC noise (forcing columns pinned to truth); fresh noise per
            # update via the step counter, so resume stays deterministic
            x0 = jnp.repeat(x0, ensemble, axis=2)
            key = base_key if step is None else jax.random.fold_in(base_key, step)
            noise = perturb_sigma * jax.random.normal(key, x0.shape, x0.dtype)
            if forcing_in.size:
                noise = noise.at[..., forcing_in].set(0.0)
            x0 = x0 + noise
        future = pre[:, multi_step:, None]  # (b, rollout, 1, grid, vars)
        truth_in = jnp.moveaxis(future[..., data_in], 1, 0)
        targets = jnp.moveaxis(future[..., data_out], 1, 0)
        return x0, truth_in, targets

    _jitted: dict = {}
    _state_sh_cell: list = [None]  # set when param_sharding places the state
    _ema_sh_cell: list = [None]

    def _step_body_for(r: int):
        core = step_core_for(r)

        def body(state, ema, raw):
            x0, truth_in, targets = prep(raw, step=state.step)
            if r == 1:
                state, loss = core(state, x0, targets[0])
            else:
                state, loss = core(state, x0, truth_in[:r], targets[:r])
            if ema_decay is not None:
                ema = ema_update(ema, state.params, ema_decay)
            return state, ema, loss

        return body

    def step_fn_for(r: int, k: int = 1):
        """One jitted program running ``k`` sequential optimizer steps over a
        tuple of ``k`` staged batches (unrolled — scan executes poorly on the
        dispatch-bound runtimes this amortization targets). Returns the
        per-step losses so logging stays per-step exact."""
        if (r, k) not in _jitted:
            body = _step_body_for(r)

            def multi(state, ema, raws):
                step_losses = []
                for raw in raws:
                    state, ema, loss = body(state, ema, raw)
                    step_losses.append(loss)
                return state, ema, jnp.stack(step_losses)

            out_sh = None
            if _state_sh_cell[0] is not None:
                # pin state/EMA outputs to the ZeRO/FSDP layout so every
                # step round-trips the same buffers (losses stay auto)
                out_sh = (_state_sh_cell[0], _ema_sh_cell[0], None)
            _jitted[(r, k)] = (
                jax.jit(multi, donate_argnums=(0, 1), out_shardings=out_sh)
                if out_sh is not None
                else jax.jit(multi, donate_argnums=(0, 1))
            )
        return _jitted[(r, k)]

    ckpt_path = os.path.join(checkpoint_dir, "latest") if checkpoint_dir else None
    if checkpoint_dir:
        # graph-once layout: the graph is immutable across a run, so write
        # it one time as a sibling graph.npz instead of re-serializing it
        # into every periodic checkpoint (GB-scale at O1280);
        # from_checkpoint finds it automatically
        os.makedirs(checkpoint_dir, exist_ok=True)
        graph_path = os.path.join(checkpoint_dir, "graph.npz")
        if not os.path.exists(graph_path):
            graph.save(graph_path)

    metrics_path = os.path.join(checkpoint_dir, "metrics.jsonl") if checkpoint_dir else None

    def log_metrics(record: dict) -> None:
        if metrics_path:
            import json

            with open(metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    with use_mesh(mesh):
        # init on a full-size batch: under a mesh the model's batch-axis
        # sharding needs batch % data-axis == 0, and batch_size is what the
        # loader will deliver
        example = jnp.asarray(np.broadcast_to(first, (batch_size,) + first.shape[1:]))
        x0_ex, *_ = prep(example)
        state = init_state(jax.random.key(seed), x0_ex)
        # distinct buffers: state and ema are both donated into the jitted step
        ema = jax.tree_util.tree_map(jnp.copy, state.params) if ema_decay is not None else None
        start_step = 0

        if warm is not None and not (resume and ckpt_path and os.path.exists(ckpt_path)):
            state = state._replace(
                params=warm["params"], opt_state=optimizer.init(warm["params"])
            )
            if ema_decay is not None:
                ema = jax.tree_util.tree_map(jnp.copy, state.params)
            log(f"warm-started parameters from {init_from}")

        if resume and ckpt_path and os.path.exists(ckpt_path):
            from anemoi_models_tpu.checkpoint import load_checkpoint

            opt_target = {"opt": state.opt_state}
            if ema_decay is not None:
                opt_target["ema"] = ema
            target = {"params": state.params, "opt_state": opt_target}
            proc_state = iface.pre_processors.state_dict()
            if proc_state:  # empty pipelines save no processor subtree
                target["processor_state"] = proc_state
            restored = load_checkpoint(ckpt_path, target=target)
            if "processor_state" in restored:
                iface.pre_processors.load_state_dict(restored["processor_state"])
                iface.post_processors.load_state_dict(restored["processor_state"])
            start_step = int(restored.get("step") or 0)
            state = state._replace(
                params=restored["params"],
                opt_state=restored["opt_state"]["opt"],
                step=jnp.asarray(start_step, jnp.int32),
            )
            ema = restored["opt_state"].get("ema") if ema_decay is not None else None
            samp = (restored.get("metadata") or {}).get("sampler")
            if samp:
                sampler.restore(samp)
            log(f"resumed from {ckpt_path} at step {start_step}")

        iface.params = state.params

        # the background loader pulls ahead of training, so sampler.state()
        # overshoots mid-run saves by the queue depth; reconstruct the exact
        # position for a given trained-step count from the pre-loader base
        base_epoch, base_pos = sampler.epoch, sampler.position
        bpe = sampler.batches_per_epoch

        def sampler_state_at(consumed: int) -> dict:
            total = base_epoch * bpe + base_pos + consumed
            return {"epoch": total // bpe, "position": total % bpe, "seed": sampler.seed}

        def save(step_no: int) -> None:
            if not ckpt_path:
                return
            opt_tree = {"opt": state.opt_state}
            if ema_decay is not None:
                opt_tree["ema"] = ema
            # interface.save makes the checkpoint self-contained (graph,
            # statistics, variable table) — directly servable via
            # AnemoiModelInterface.from_checkpoint
            iface.params = state.params
            iface.metadata["sampler"] = sampler_state_at(step_no - start_step)
            iface.save(ckpt_path, opt_state=opt_tree, step=step_no, include_graph=False)

        sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            sharding = NamedSharding(mesh, PartitionSpec("data", None, None, None))

        if mesh is not None and param_sharding:
            # ZeRO-1 / FSDP placement (parallel/fsdp.py): moments (and under
            # "fsdp" the params/EMA too) are sharded over an axis instead of
            # replicated per chip; the jitted step is pinned to the same
            # layout so donation reuses the buffers in place
            from anemoi_models_tpu.parallel.fsdp import shard_train_state

            state, ema, _state_sh_cell[0], _ema_sh_cell[0] = shard_train_state(
                state, mesh, mode=param_sharding, axis=param_sharding_axis, ema=ema
            )
            log(f"parameter sharding: {param_sharding} over the "
                f"'{param_sharding_axis}' axis ({int(mesh.shape[param_sharding_axis])}-way)")

        remaining = steps - start_step
        if max_steps_this_run is not None:
            remaining = min(remaining, max_steps_this_run)
        losses: list[float] = []
        evals: list[dict] = []
        if remaining <= 0:
            log(f"checkpoint already at step {start_step} >= steps={steps}; nothing to do")

        stop_requested = []
        if handle_signals:
            import signal
            import threading

            if threading.current_thread() is threading.main_thread():
                def _request_stop(signum, frame):
                    log(f"signal {signum}: finishing the in-flight step, then "
                        "checkpointing and stopping")
                    stop_requested.append(signum)

                prev_handlers = {
                    sig: signal.signal(sig, _request_stop)
                    for sig in (signal.SIGTERM, signal.SIGINT)
                }
            else:
                prev_handlers = {}
        else:
            prev_handlers = {}

        loader = BatchLoader(source, sampler, depth=loader_depth,
                             max_batches=remaining, workers=loader_workers)
        t_seg, i_seg = time.perf_counter(), 0
        profiling = False
        try:
            stream = device_prefetch(
                (ingest(b) for b in loader), prefetch=prefetch, sharding=sharding
            )
            cur_rollout = None
            spc = max(int(steps_per_call), 1)

            def event_step(s: int) -> bool:
                """Steps that need the live state right after they run —
                they force a call-group boundary so cadence stays exact."""
                return bool(
                    (eval_every and s % eval_every == 0)
                    or (save_every and ckpt_path and s % save_every == 0)
                    or (profile_dir and s - start_step in tuple(profile_steps))
                )

            def _flush_logs(flushed, step_losses):
                nonlocal t_seg, i_seg
                last = flushed[-1]
                want_log = [
                    s for s in flushed if s % max(log_every, 1) == 0 or s == steps
                ]
                if not want_log:
                    return
                # host fetch: all queued steps have executed
                lvals = np.asarray(step_losses)
                now = time.perf_counter()
                rate = (last - start_step - i_seg) / max(now - t_seg, 1e-9)
                t_seg, i_seg = now, last - start_step
                for s in want_log:
                    lv = float(lvals[s - flushed[0]])
                    losses.append(lv)
                    log(f"step {s:6d}  loss {lv:.5f}  ({rate:.2f} steps/s)")
                    log_metrics({"step": s, "loss": lv, "steps_per_s": round(rate, 4)})

            group: list = []
            group_nos: list[int] = []
            pending = None  # deferred (flushed, step_losses) awaiting host fetch
            for i, raw in enumerate(stream):
                step_no = start_step + i + 1
                r = rollout_at(step_no)
                if r != cur_rollout:
                    if cur_rollout is not None:
                        log(f"rollout curriculum: {cur_rollout} -> {r} at step {step_no}")
                    cur_rollout = r
                group.append(raw)
                group_nos.append(step_no)
                if not (
                    len(group) >= spc
                    or event_step(step_no)
                    or rollout_at(step_no + 1) != r
                    or step_no >= start_step + remaining
                    or stop_requested
                ):
                    continue
                state, ema, step_losses = step_fn_for(r, len(group))(
                    state, ema, tuple(group)
                )
                flushed, group, group_nos = group_nos, [], []
                step_no = flushed[-1]
                # dispatch happened (async); NOW fetch the previous group's
                # losses — the device is already past them, so the fetch
                # costs nothing and the next group's batches staged while
                # this group executed (the overlap lever)
                if pending is not None:
                    _flush_logs(*pending)
                    pending = None
                needs_state_now = (
                    event_step(step_no)
                    or stop_requested
                    or step_no >= start_step + remaining
                )
                if overlap_calls and not needs_state_now:
                    pending = (flushed, step_losses)
                else:
                    _flush_logs(flushed, step_losses)
                loss = step_losses[-1]
                if eval_every and step_no % eval_every == 0:
                    scores = _eval_tail(
                        iface, source, eval_rollout,
                        state.params if ema is None else ema,
                    )
                    evals.append({"step": step_no, **scores})
                    log_metrics({"step": step_no, "eval_rmse": scores["rmse_mean"],
                                 "eval_skill": scores["skill_mean"]})
                    log(
                        f"eval @ {step_no}: rollout-{eval_rollout} rmse "
                        f"{scores['rmse_mean']:.5f}  skill vs persistence "
                        f"{scores['skill_mean']:+.3f}"
                    )
                if save_every and ckpt_path and step_no % save_every == 0:
                    save(step_no)
                if profile_dir and step_no - start_step == profile_steps[0]:
                    jax.profiler.start_trace(profile_dir)
                    profiling = True
                if profiling and step_no - start_step >= profile_steps[1]:
                    jax.block_until_ready(loss)
                    jax.profiler.stop_trace()
                    profiling = False
                    log(f"profile trace written to {profile_dir}")
                if stop_requested:
                    final_step = step_no
                    save(final_step)
                    iface.params = state.params
                    log(f"stopped at step {step_no} on request; checkpoint saved")
                    return {
                        "state": state, "ema": ema, "interface": iface,
                        "graph": graph, "losses": losses, "eval": evals,
                        "steps_done": step_no, "checkpoint": ckpt_path,
                        "interrupted": True,
                    }
        finally:
            if profiling:  # run ended before the stop step: flush the trace
                try:
                    jax.profiler.stop_trace()
                    log(f"profile trace written to {profile_dir} (early stop)")
                except Exception:
                    pass
            loader.close()
            for sig, handler in prev_handlers.items():
                import signal

                signal.signal(sig, handler)

        if pending is not None:
            _flush_logs(*pending)
            pending = None
        final_step = start_step + max(remaining, 0)
        if ckpt_path and remaining > 0:
            save(final_step)
        iface.params = state.params

    return {
        "state": state,
        "ema": ema,
        "interface": iface,
        "graph": graph,
        "losses": losses,
        "eval": evals,
        "steps_done": final_step,
        "checkpoint": ckpt_path,
    }


def _eval_tail(iface, source, eval_rollout, params) -> dict:
    """Score an autoregressive rollout on the held-out dataset tail."""
    scores = evaluate_interface(iface, source, n_steps=eval_rollout, params=params)
    return {
        "rmse_mean": float(np.mean(scores["rmse"])),
        "skill_mean": float(np.mean(scores["skill_vs_persistence"])),
        "rmse": scores["rmse"].tolist(),
    }
